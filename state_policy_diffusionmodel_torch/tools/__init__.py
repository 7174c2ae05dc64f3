"""The JAX package's data and checkpoint tools (`tools/*.py`), ported: each
runs as `python -m state_policy_diffusionmodel_torch.tools.<name>` with
the JAX tool's arguments."""
