"""remixt-jax packaging.

Builds the native BAM allele reader shared library (src/bam_allele_reader.cpp)
as part of the wheel; the compute path (JAX/XLA) needs no compiled
extensions.
"""

import os
import subprocess

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py


class BuildNative(build_py):
    """Compile the BAM reader shared library into the package tree."""

    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(here, 'src', 'bam_allele_reader.cpp')
        out_dir = os.path.join(here, 'remixt_jax', 'io', '_native')
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, 'libbamallele.so')
        subprocess.check_call([
            'g++', '-O2', '-std=c++17', '-shared', '-fPIC', src, '-o', out, '-lz'])
        super().run()


setup(
    name='remixt-jax',
    version='0.1.0',
    description=('JAX joint inference of clone-specific segment and '
                 'breakpoint copy number from tumour WGS data'),
    packages=find_packages(include=['remixt_jax', 'remixt_jax.*']),
    package_data={'remixt_jax.io': ['_native/libbamallele.so']},
    cmdclass={'build_py': BuildNative},
    entry_points={
        'console_scripts': [
            'remixt-jax = remixt_jax.ui.main:main',
        ],
    },
    install_requires=[
        'jax',
        'numpy',
        'scipy',
        'pandas',
        'h5py',
        'scikit-learn',
        'networkx',
        'matplotlib',
        'seaborn',
        'pyyaml',
    ],
    python_requires='>=3.10',
)
