"""Test configuration: force an 8-device virtual CPU mesh.

Tests run on the CPU; multi-device sharding is validated on XLA's
host-platform device simulation (see SURVEY.md §4).  Code that only runs
compiled on the GPU (the Triton tracker kernel) is tested here in the
Pallas interpreter, and on the card by chip_smoke.py.
"""

import os

os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ.setdefault('JAX_ENABLE_X64', '0')

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_num_cpu_devices', 8)

# persistent compilation cache: repeated test runs skip XLA recompiles
from dumphfdl_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
