"""Command-line entry points of the port, run as `python -m state_policy_diffusionmodel_torch.cli.<name>`."""
