"""Model configurations: DLRM-MLPerf and the dense LMs; ``registry``
looks an arch up by name."""
