"""Model configurations; DLRM-MLPerf is the first one ported."""
