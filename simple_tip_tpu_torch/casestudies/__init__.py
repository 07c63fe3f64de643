"""Case studies of the port: training, checkpoints and test_prio per run."""
