"""``remixt-jax plot_results``: figures from a results store.

Capability parity with the reference's ``remixt plot_results``
(/root/reference/remixt/ui/plot_results.py:19-59): a minor-depth plot with
mode annotations, a raw major/minor scatter, and a genome-wide raw
copy-number track restricted to well-covered segments.
"""

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt
import seaborn

import remixt_jax.cn_plot
from remixt_jax.io.hdf5 import HDFStore


def _plot_depth(store, ax):
    remixt_jax.cn_plot.plot_depth(
        ax, store['/read_depth'], minor_modes=store['/minor_modes'])
    seaborn.despine(trim=True)


def _plot_scatter(store, ax):
    remixt_jax.cn_plot.plot_cnv_scatter(
        ax, store['/cn'], major_col='major_raw', minor_col='minor_raw')


def _plot_raw_genome(store, ax):
    cnv = store['/cn']
    # only segments with most of their span effectively covered
    span = cnv['end'] - cnv['start']
    cnv = cnv[(cnv['length'] > 1e5) & (cnv['length'] > 0.75 * span)]
    remixt_jax.cn_plot.plot_cnv_genome(
        ax, cnv, major_col='major_raw', minor_col='minor_raw', maxcopies=6)


_PLOTS = {
    'depth': (_plot_depth, (8, 5)),
    'scatter': (_plot_scatter, (8, 8)),
    'raw': (_plot_raw_genome, (12, 2)),
}

plot_choices = list(_PLOTS.keys())


def create_plot(**args):
    draw, figsize = _PLOTS[args['plot_type']]
    seaborn.set_style('ticks')
    fig = plt.figure(figsize=figsize)
    with HDFStore(args['results'], 'r') as store:
        draw(store, plt.gca())
    fig.savefig(args['plot_file'], bbox_inches='tight')


def add_arguments(argparser):
    argparser.add_argument('results', help='Results to visualize')
    argparser.add_argument('plot_file', help='Output plot filename')
    argparser.add_argument('plot_type', help='Output plot type',
                           choices=plot_choices)
    argparser.set_defaults(func=create_plot)
