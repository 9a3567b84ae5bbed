"""nbody_tpu — a gravitational N-body framework for the GPU.

Built from scratch in JAX/XLA/Pallas with the capabilities of the
NTHU-SC/nbody-demo-2023 reference (see SURVEY.md for the structural map):
all-pairs softened gravity, semi-implicit Euler integration, kinetic-energy
diagnostics, the reference's benchmark table, a pluggable kernel registry
(naive jnp / tiled Pallas), and GSPMD particle-sharded multi-device
scaling.
"""

from .config import SimConfig
from .init import make_state, reference_init_arrays
from .models.gravity import euler_step, kinetic_energy, make_block_fn
from .simulation import RunResult, Simulation, run
from .state import ParticleState

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "Simulation",
    "RunResult",
    "run",
    "ParticleState",
    "make_state",
    "reference_init_arrays",
    "euler_step",
    "kinetic_energy",
    "make_block_fn",
    "__version__",
]
