"""Poll proving orchestration and the reference-dims end-to-end run."""
