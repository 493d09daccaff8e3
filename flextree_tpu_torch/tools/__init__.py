"""Command-line tools of the port: ``python -m
flextree_tpu_torch.tools.calibrate_host`` fits the planner's cost-model
constants on the backend it runs on."""
