"""Models of the zoo; DLRM is the first one ported."""
