"""The accelerator a measurement ran on.

Every result a benchmark or smoke run prints names its device: JAX's
platform, device kind and device count, plus the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum power
runs slower under load). A measurement path that finds no GPU fails; it
does not fall back to the CPU.
"""

import shutil
import subprocess

import jax


def nvidia_smi():
    """``nvidia-smi --query-gpu=name,power.limit`` lines, or None when the
    tool is absent."""
    if shutil.which('nvidia-smi') is None:
        return None
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def describe():
    """Platform, kind and count of JAX's devices."""
    devices = jax.devices()
    return {'platform': devices[0].platform,
            'kind': devices[0].device_kind,
            'count': len(devices)}


def require_gpu():
    """:func:`describe`, after checking that JAX's default device is a GPU.

    Raises RuntimeError otherwise."""
    device = describe()
    if device['platform'] != 'gpu':
        raise RuntimeError(
            'this measurement needs a GPU; JAX found {platform} '
            '({kind}, {count} devices)'.format(**device))
    return device
