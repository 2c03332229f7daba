"""Copy-number plotting (matplotlib).

API parity with /root/reference/remixt/cn_plot.py:36-765: genome-wide
copy-number tracks, major/minor scatter, read-depth densities, experiment
summary figures and the per-candidate-ploidy analysis PDF. Implementations
are original matplotlib.
"""

import matplotlib
matplotlib.use('Agg')

import matplotlib.pyplot as plt
import matplotlib.colors
import numpy as np
import pandas as pd

import remixt_jax.utils
import remixt_jax.likelihood
import remixt_jax.analysis.experiment
import remixt_jax.analysis.readdepth


MAJOR_COLOR = '#d62728'
MINOR_COLOR = '#1f77b4'


def _chromosome_layout(cnv, chromosomes=None):
    """Concatenated-genome x-axis layout: chromosome -> (offset, length)."""
    if chromosomes is None:
        chromosomes = remixt_jax.utils.sort_chromosome_names(
            cnv['chromosome'].unique())
    info = {}
    offset = 0
    for chromosome in chromosomes:
        chrom_cnv = cnv[cnv['chromosome'] == chromosome]
        if len(chrom_cnv.index) == 0:
            continue
        length = chrom_cnv['end'].max()
        info[chromosome] = (offset, length)
        offset += length
    return info


def create_chromosome_color_map(chromosomes):
    """Distinct color per chromosome (cn_plot.py:257-282)."""
    cmap = plt.get_cmap('tab20')
    return {c: cmap(i % 20) for i, c in enumerate(chromosomes)}


def plot_cnv_segments(ax, cnv, major_col='major', minor_col='minor',
                      do_fill=False):
    """Step plot of major/minor copy number segments (cn_plot.py:36-99)."""
    for col, color in [(major_col, MAJOR_COLOR), (minor_col, MINOR_COLOR)]:
        for _, row in cnv.iterrows():
            ax.plot([row['plot_start'], row['plot_end']],
                    [row[col], row[col]], color=color, lw=1.5,
                    solid_capstyle='butt')
            if do_fill:
                ax.fill_between([row['plot_start'], row['plot_end']],
                                0, row[col], color=color, alpha=0.1)


def plot_cnv_genome(ax, cnv, mincopies=-0.4, maxcopies=4, minlength=1000,
                    major_col='major', minor_col='minor', chromosomes=None):
    """Genome-wide copy-number track with chromosome boundaries
    (cn_plot.py:102-210)."""
    cnv = cnv[cnv['end'] - cnv['start'] >= minlength].copy()
    layout = _chromosome_layout(cnv, chromosomes)

    cnv = cnv[cnv['chromosome'].isin(layout.keys())].copy()
    offsets = cnv['chromosome'].map(lambda c: layout[c][0])
    cnv['plot_start'] = cnv['start'] + offsets
    cnv['plot_end'] = cnv['end'] + offsets

    plot_cnv_segments(ax, cnv, major_col=major_col, minor_col=minor_col)

    for chromosome, (offset, length) in layout.items():
        ax.axvline(offset, color='0.8', lw=0.5)
        ax.text(offset + length / 2, maxcopies * 1.02, str(chromosome),
                ha='center', va='bottom', fontsize=7)

    total = sum(l for _, l in layout.values())
    ax.set_xlim(0, total)
    ax.set_ylim(mincopies, maxcopies * 1.12)
    ax.set_ylabel('copy number')
    ax.set_xticks([])
    return layout


def plot_cnv_scatter(ax, cnv, major_col='major', minor_col='minor',
                     highlight_col=None, chromosome_colors=None,
                     chromosomes=None):
    """Major vs minor raw copy-number scatter, length-sized points
    (cn_plot.py:285-356)."""
    if chromosomes is None:
        chromosomes = remixt_jax.utils.sort_chromosome_names(
            cnv['chromosome'].unique())
    if chromosome_colors is None:
        chromosome_colors = create_chromosome_color_map(chromosomes)

    lengths = cnv['length'].values.astype(float)
    sizes = 40.0 * lengths / max(lengths.max(), 1.0)
    colors = cnv['chromosome'].map(chromosome_colors)

    ax.scatter(cnv[major_col], cnv[minor_col], s=sizes, c=list(colors),
               alpha=0.5, linewidths=0)
    ax.set_xlabel('major copy number')
    ax.set_ylabel('minor copy number')


def plot_depth(ax, read_depth, minor_modes=None):
    """Length-weighted density of minor/major/total depths with detected
    modes (cn_plot.py:648-680)."""
    from scipy.stats import gaussian_kde

    total = read_depth['total'].values
    xmax = np.percentile(total, 95) * 1.2
    grid = np.linspace(0, xmax, 400)

    for col, color in [('minor', MINOR_COLOR), ('major', MAJOR_COLOR),
                       ('total', '0.4')]:
        values = read_depth[col].values
        weights = read_depth['length'].values.astype(float)
        resampled = remixt_jax.utils.weighted_resample(values, weights)
        keep = resampled <= xmax
        if keep.sum() < 2:
            continue
        density = gaussian_kde(resampled[keep])
        ax.plot(grid, density(grid), color=color, label=col)

    if minor_modes is not None:
        for mode in minor_modes:
            ax.axvline(mode, color='k', ls=':', lw=0.8)

    ax.set_xlabel('depth')
    ax.set_ylabel('density')
    ax.legend(fontsize=7)


def filled_density_weighted(ax, data, weights, c, a, xmin, xmax, cov,
                            rotate=False):
    """Weighted KDE with filled area (cn_plot.py:20-33)."""
    from scipy.stats import gaussian_kde
    samples = remixt_jax.utils.weighted_resample(data, weights)
    samples = samples[(samples >= xmin) & (samples <= xmax)]
    if len(samples) < 2:
        return
    density = gaussian_kde(samples, bw_method=cov)
    grid = np.linspace(xmin, xmax, 300)
    values = density(grid)
    if rotate:
        ax.fill_betweenx(grid, 0, values, color=c, alpha=a)
    else:
        ax.fill_between(grid, 0, values, color=c, alpha=a)


def plot_breakpoints_genome(ax, breakpoint, chromosome_info, scale_height=1.0):
    """Breakpoint arcs over a genome axis (cn_plot.py:430-471).

    `chromosome_info` maps chromosome -> (offset, length) as produced by
    plot_cnv_genome; `breakpoint` is a prediction table with
    chromosome_1/2 and position_1/2 columns.
    """
    from matplotlib.patches import Arc

    ymin, ymax = ax.get_ylim()
    for _, row in breakpoint.iterrows():
        c1, c2 = str(row['chromosome_1']), str(row['chromosome_2'])
        if c1 not in chromosome_info or c2 not in chromosome_info:
            continue
        x1 = chromosome_info[c1][0] + row['position_1']
        x2 = chromosome_info[c2][0] + row['position_2']
        center = (x1 + x2) / 2.0
        width = abs(x2 - x1)
        height = (ymax - ymin) * 0.3 * scale_height
        arc = Arc((center, ymax), width, height, theta1=180, theta2=360,
                  color='0.4', lw=0.6, alpha=0.7)
        ax.add_patch(arc)


def experiment_plot(experiment, cn, h, maxcopies=4, chromosome=None,
                    start=None, end=None):
    """Summary figure: inferred genome track per clone plus raw
    (cn_plot.py:474-555)."""
    data = remixt_jax.analysis.experiment.create_cn_table(experiment, cn, h)

    num_clones = cn.shape[1]
    fig, axes = plt.subplots(
        num_clones + 1, 1, figsize=(14, 2.5 * (num_clones + 1)), sharex=True)

    plot_cnv_genome(axes[0], data, major_col='major_raw', minor_col='minor_raw',
                    maxcopies=maxcopies)
    axes[0].set_ylabel('raw')

    for m in range(1, num_clones):
        plot_cnv_genome(axes[m], data, major_col=f'major_{m}',
                        minor_col=f'minor_{m}', maxcopies=maxcopies)
        axes[m].set_ylabel(f'clone {m}')

    plot_cnv_scatter(axes[num_clones], data, major_col='major_raw',
                     minor_col='minor_raw')

    fig.tight_layout()
    return fig


def mixture_plot(mixture):
    """Genome track of a simulated mixture's true clone copy numbers
    (cn_plot.py:558-620)."""
    data = pd.DataFrame({
        'chromosome': mixture.segment_chromosome_id,
        'start': mixture.segment_start,
        'end': mixture.segment_end,
    })
    data['length'] = data['end'] - data['start']

    M = mixture.cn.shape[1]
    fig, axes = plt.subplots(M - 1, 1, figsize=(14, 2.5 * (M - 1)),
                             sharex=True, squeeze=False)
    for m in range(1, M):
        data['major'] = mixture.cn[:, m, 0]
        data['minor'] = mixture.cn[:, m, 1]
        plot_cnv_genome(axes[m - 1][0], data)
        axes[m - 1][0].set_ylabel(f'clone {m}')
    fig.tight_layout()
    return fig


def gc_plot(gc_table_filename, plot_filename):
    """GC bias curve: binned means and LOWESS (cn_plot.py:623-645)."""
    gc_table = pd.read_csv(gc_table_filename, sep='\t')
    fig = plt.figure(figsize=(6, 4))
    ax = fig.add_subplot(111)
    ax.scatter(gc_table['gc_bin'], gc_table['mean'], s=4, c='0.6',
               label='binned mean')
    ax.plot(gc_table['gc_bin'], gc_table['smoothed'], c=MAJOR_COLOR,
            label='lowess')
    ax.set_xlabel('gc percent bin')
    ax.set_ylabel('normalized read rate')
    ax.legend()
    fig.savefig(plot_filename, bbox_inches='tight')
    plt.close(fig)


def plot_experiment(experiment_plot_filename, experiment_filename):
    """Plot a simulated experiment's true mixture (cn_plot.py:683-696)."""
    import pickle
    with open(experiment_filename, 'rb') as f:
        experiment = pickle.load(f)
    fig = experiment_plot(
        experiment, experiment.cn, experiment.h)
    fig.savefig(experiment_plot_filename, bbox_inches='tight')
    plt.close(fig)


def plot_mixture(mixture_plot_filename, mixture_filename):
    """Plot a simulated genome mixture (cn_plot.py:699-712)."""
    import pickle
    with open(mixture_filename, 'rb') as f:
        mixture = pickle.load(f)
    fig = mixture_plot(mixture)
    fig.savefig(mixture_plot_filename, bbox_inches='tight')
    plt.close(fig)


def ploidy_analysis_plots(experiment_filename, plots_filename, chromosomes=None):
    """Depth modes and per-candidate-h raw scatter plots as a PDF
    (cn_plot.py:715-762)."""
    import pickle
    from matplotlib.backends.backend_pdf import PdfPages

    with open(experiment_filename, 'rb') as f:
        experiment = pickle.load(f)

    read_depth = remixt_jax.analysis.readdepth.calculate_depth(experiment)
    minor_modes = remixt_jax.analysis.readdepth.calculate_minor_modes(read_depth)
    h_candidates = remixt_jax.analysis.readdepth.calculate_candidate_h_monoclonal(
        minor_modes)

    with PdfPages(plots_filename) as pdf:
        fig = plt.figure(figsize=(8, 5))
        ax = fig.add_subplot(111)
        plot_depth(ax, read_depth, minor_modes=minor_modes)
        ax.set_title('read depth distribution')
        pdf.savefig(fig, bbox_inches='tight')
        plt.close(fig)

        for idx, h_mono in enumerate(h_candidates):
            h = np.asarray(h_mono)
            data = read_depth.copy()
            data['major_raw'] = (data['major'] - h[0]) / h[1:].sum()
            data['minor_raw'] = (data['minor'] - h[0]) / h[1:].sum()

            fig = plt.figure(figsize=(6, 6))
            ax = fig.add_subplot(111)
            plot_cnv_scatter(ax, data, major_col='major_raw', minor_col='minor_raw')
            ploidy = remixt_jax.analysis.readdepth.estimate_ploidy(h, experiment)
            ax.set_title(f'candidate {idx}: h={np.round(h, 4)} ploidy={ploidy:.2f}')
            pdf.savefig(fig, bbox_inches='tight')
            plt.close(fig)


def plot_cnv_genome_density(fig, transform, cnv, chromosomes=None,
                            maxcopies=6):
    """Genome-wide raw copy-number track with a rotated marginal density
    panel on the right (cn_plot.py:213-254 capability).

    ``transform`` is a (x, y, width, height) box in figure coordinates that
    the two panels split 85/15.
    """
    box_x, box_y, box_w, box_h = transform
    ax_genome = fig.add_axes([box_x, box_y, box_w * 0.84, box_h])
    ax_density = fig.add_axes(
        [box_x + box_w * 0.86, box_y, box_w * 0.14, box_h],
        sharey=ax_genome)

    plot_cnv_genome(ax_genome, cnv, maxcopies=maxcopies,
                    major_col='major_raw', minor_col='minor_raw',
                    chromosomes=chromosomes)

    lengths = cnv['length'].values.astype(float)
    for col, color in (('major_raw', MAJOR_COLOR), ('minor_raw', MINOR_COLOR)):
        filled_density_weighted(
            ax_density, cnv[col].values, lengths, color, 0.5,
            -0.5, maxcopies + 0.5, 0.05, rotate=True)
    ax_density.set_xticks([])
    plt.setp(ax_density.get_yticklabels(), visible=False)
    return ax_genome, ax_density


def plot_cnv_scatter_density(fig, transform, cnv, major_col='major_raw',
                             minor_col='minor_raw', annotate=(), info='',
                             chromosomes=None, maxcopies=6):
    """Major/minor scatter with marginal densities on both axes
    (cn_plot.py:359-427 capability).

    ``annotate`` lists (major, minor) state points to mark; ``info`` is a
    caption placed in the spare corner panel.
    """
    box_x, box_y, box_w, box_h = transform
    ax_scatter = fig.add_axes(
        [box_x, box_y, box_w * 0.78, box_h * 0.78])
    ax_top = fig.add_axes(
        [box_x, box_y + box_h * 0.80, box_w * 0.78, box_h * 0.18],
        sharex=ax_scatter)
    ax_right = fig.add_axes(
        [box_x + box_w * 0.80, box_y, box_w * 0.18, box_h * 0.78],
        sharey=ax_scatter)

    plot_cnv_scatter(ax_scatter, cnv, major_col=major_col,
                     minor_col=minor_col, chromosomes=chromosomes)
    ax_scatter.set_xlim(-0.5, maxcopies + 0.5)
    ax_scatter.set_ylim(-0.5, maxcopies + 0.5)

    lengths = cnv['length'].values.astype(float)
    filled_density_weighted(ax_top, cnv[major_col].values, lengths,
                            MAJOR_COLOR, 0.5, -0.5, maxcopies + 0.5, 0.05)
    filled_density_weighted(ax_right, cnv[minor_col].values, lengths,
                            MINOR_COLOR, 0.5, -0.5, maxcopies + 0.5, 0.05,
                            rotate=True)
    for marker in annotate:
        ax_scatter.plot([marker[0]], [marker[1]], marker='x', ms=8,
                        color='k', zorder=5)
    if info:
        fig.text(box_x + box_w * 0.82, box_y + box_h * 0.92, info,
                 fontsize=8, va='top')
    ax_top.set_yticks([])
    ax_right.set_xticks([])
    plt.setp(ax_top.get_xticklabels(), visible=False)
    plt.setp(ax_right.get_yticklabels(), visible=False)
    return ax_scatter
