"""Interactive matplotlib results browser (parity with reference
tools/remixt_browser.py): genome copy-number track with solution paging via
arrow keys, backed by a results HDF5 store.
"""

import argparse
import os
import sys

import matplotlib.pyplot as plt

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import remixt_jax.cn_plot
from remixt_jax.io.hdf5 import HDFStore


class Browser(object):
    def __init__(self, results_filename):
        self.store = HDFStore(results_filename, 'r')
        self.stats = self.store['stats'].sort_values('elbo', ascending=False)
        self.solution_ids = list(self.stats['init_id'].values)
        self.index = 0

        self.fig, self.ax = plt.subplots(figsize=(14, 4))
        self.fig.canvas.mpl_connect('key_press_event', self.on_key)
        self.draw()

    def on_key(self, event):
        if event.key == 'right':
            self.index = (self.index + 1) % len(self.solution_ids)
        elif event.key == 'left':
            self.index = (self.index - 1) % len(self.solution_ids)
        else:
            return
        self.draw()

    def draw(self):
        solution_id = self.solution_ids[self.index]
        cn = self.store['solutions/solution_{}/cn'.format(solution_id)]
        row = self.stats[self.stats['init_id'] == solution_id].iloc[0]

        self.ax.clear()
        remixt_jax.cn_plot.plot_cnv_genome(
            self.ax, cn, major_col='major_raw', minor_col='minor_raw',
            maxcopies=6)
        self.ax.set_title(
            'solution {} (elbo {:.2f}, ploidy {:.2f}) — arrows to browse'
            .format(solution_id, row['elbo'], row['ploidy']))
        self.fig.canvas.draw()


if __name__ == '__main__':
    argparser = argparse.ArgumentParser()
    argparser.add_argument('results', help='results HDF5 filename')
    args = argparser.parse_args()

    browser = Browser(args.results)
    plt.show()
