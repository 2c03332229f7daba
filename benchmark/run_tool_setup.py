"""Competitor-tool installation helper.

Mirrors /root/reference/benchmark/run_tool_setup.py — fetches and builds
the external tools the benchmark wrappers drive. Each step is guarded by
a sentinel file so re-runs resume; network access and the build
prerequisites (git, R, make, octave) are required.

Usage:
    python benchmark/run_tool_setup.py <install_dir> [--tools titan theta clonehd]
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from remixt_jax.utils import AutoSentinal


def _run(command, cwd=None):
    print('+ ' + command, flush=True)
    subprocess.check_call(command, shell=True, cwd=cwd)


def install_titan(install_dir):
    """TitanCNA R package + the segment-file scripts its wrapper drives."""
    sent = AutoSentinal(os.path.join(install_dir, '.sentinel_titan_'))

    def install_r_packages():
        for pkg in ('optparse', 'data.table', 'GenomicRanges', 'TitanCNA'):
            _run('R -q -e "if (!requireNamespace(\'{0}\', quietly=TRUE)) '
                 'install.packages(\'{0}\', '
                 'repos=\'https://cloud.r-project.org\')"'.format(pkg))
    sent.run(install_r_packages)

    def clone_titan_utils():
        _run('git clone https://github.com/gavinha/TitanCNA '
             '{}/TitanCNA'.format(install_dir))
    sent.run(clone_titan_utils)


def install_theta(install_dir):
    sent = AutoSentinal(os.path.join(install_dir, '.sentinel_theta_'))

    def clone_and_build():
        _run('git clone https://github.com/raphael-group/THetA '
             '{}/THetA'.format(install_dir))
        _run('make', cwd=os.path.join(install_dir, 'THetA'))
    sent.run(clone_and_build)


def install_clonehd(install_dir):
    sent = AutoSentinal(os.path.join(install_dir, '.sentinel_clonehd_'))

    def clone_and_build():
        _run('git clone https://github.com/andrej-fischer/cloneHD '
             '{}/cloneHD'.format(install_dir))
        _run('make -C src', cwd=os.path.join(install_dir, 'cloneHD'))
    sent.run(clone_and_build)


INSTALLERS = {
    'titan': install_titan,
    'theta': install_theta,
    'clonehd': install_clonehd,
}


def main():
    argparser = argparse.ArgumentParser()
    argparser.add_argument('install_dir')
    argparser.add_argument('--tools', nargs='+',
                           default=list(INSTALLERS.keys()),
                           choices=list(INSTALLERS.keys()))
    args = argparser.parse_args()

    os.makedirs(args.install_dir, exist_ok=True)
    for tool in args.tools:
        print('=== installing {} ==='.format(tool), flush=True)
        INSTALLERS[tool](args.install_dir)
    print('done; point the benchmark config at the install locations '
          '(see remixt_jax/wrappers/wrapexternal.py docstring)')


if __name__ == '__main__':
    main()
