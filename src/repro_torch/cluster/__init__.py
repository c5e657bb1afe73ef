"""Host-side cluster orchestration driven by the paper's policy."""
