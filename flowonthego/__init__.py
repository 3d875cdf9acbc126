"""flowonthego — dense optical flow in JAX.

A JAX/XLA/Pallas implementation of Kroeger et al.'s Dense Inverse Search
optical flow (the capability set of the FlowOnTheGo CUDA/Jetson
reference): batched patch tensors, a persistent Gauss-Newton kernel,
overlap-add densification, red-black SOR stencils, and jax.sharding-based
frame/tile parallelism.
"""

from .config import DISConfig, operating_point, auto_coarsest_scale, pad_to_divisible
from .models.dis_flow import DISFlow, compute_flow, dis_flow_padded
from .io import (read_flo, write_flo, load_image, save_image, flow_to_color,
                 read_pfm, write_pfm)
from .utils.metrics import average_epe, endpoint_error

__version__ = "0.1.0"

__all__ = [
    "DISConfig", "operating_point", "auto_coarsest_scale", "pad_to_divisible",
    "DISFlow", "compute_flow", "dis_flow_padded",
    "read_flo", "write_flo", "load_image", "save_image", "flow_to_color",
    "read_pfm", "write_pfm", "average_epe", "endpoint_error",
]
