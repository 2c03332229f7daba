"""Persistent XLA compilation cache.

Compiling the whole-genome fit's programs is set-up time that every fresh
process pays; JAX's persistent compilation cache serializes executables to
a directory keyed by (HLO, compile options, backend version), so a later
process loads them instead. The cache key includes the directory, so the
directory is fixed: JAX's own ``JAX_COMPILATION_CACHE_DIR`` when set (the
program then sets no directory of its own), else ``.jax_cache`` at the
root of the checkout.

No reference counterpart; the ``use_compilation_cache`` option in
defaults.py turns it off.
"""

import logging
import os

logger = logging.getLogger('remixt_jax.compile_cache')

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.jax_cache')

_enabled_dir = None


def cache_dir():
    """The directory the persistent cache uses."""
    return os.environ.get('JAX_COMPILATION_CACHE_DIR') or REPO_CACHE_DIR


def enable_compilation_cache(config=None):
    """Idempotently point JAX's persistent compilation cache at
    :func:`cache_dir`.

    A falsy ``use_compilation_cache`` in the config leaves the cache as
    JAX has it. Returns the active directory, or None when not enabled.
    """
    global _enabled_dir
    import jax
    import remixt_jax.config

    if config is not None and not remixt_jax.config.get_param(
            config, 'use_compilation_cache'):
        return None
    if _enabled_dir is not None:
        return _enabled_dir

    directory = cache_dir()
    if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        jax.config.update('jax_compilation_cache_dir', directory)
    _enabled_dir = directory
    logger.info('persistent compilation cache at %s', directory)
    return directory
