# The paper's primary contribution: black-box trial-and-error tuning of
# the 12-knob execution configuration.  This slice of the port carries
# the knob space (space, params); the tuner's walk follows.
from repro_torch.core.params import TunableConfig, default_config  # noqa: F401
