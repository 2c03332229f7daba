"""Test configuration: JAX on a virtual 8-device CPU mesh with x64, and no
persistent compilation cache.

Multi-device sharding logic is validated on the host mesh (8 virtual CPU
devices); float64 enables near-machine-precision comparison between the
JAX engine and the numpy oracle.

The environment variables also reach every subprocess the tests spawn
(the scheduler's process pool, CLI round-trips), so those come up on the
CPU too and never read or write a compilation cache.
"""

import os

os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['JAX_ENABLE_COMPILATION_CACHE'] = 'false'
_flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8')

import jax  # noqa: E402

# jax may have been imported before this module ran (a plugin or another
# conftest), in which case the environment above was read too early to
# matter; the backend is initialized lazily, so setting the config here
# still takes effect
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_num_cpu_devices', 8)
jax.config.update('jax_enable_x64', True)
jax.config.update('jax_enable_compilation_cache', False)
