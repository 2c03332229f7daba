"""Export a merged evaluation store to a readable checked-in JSON.

Usage: python benchmark/export_evaluation.py <merged.h5> <out.json>

Besides the per-simulation records, a ``summary`` section reports each
configuration's mean/std/min/max over its replicates for the headline
accuracy metrics (sim ids are ``<config>_<sim>_<rep>``), so checked-in
accuracy claims carry error bars.
"""

import json
import os
import sys

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from remixt_jax.io.hdf5 import HDFStore


SUMMARY_METRICS = {
    'cn_evaluation': ['proportion_cn_correct', 'proportion_dom_cn_correct',
                      'proportion_clonal_correct',
                      'proportion_subclonal_correct'],
    'brk_cn_evaluation': ['brk_cn_correct_proportion'],
    'mix_results': ['mix_abs_error'],
}


def _config_of(sim_id):
    """``<config>_<sim_idx>_<rep_idx>`` -> config name."""
    return sim_id.rsplit('_', 2)[0]


def summarize(tables):
    """{config: {metric: {mean, std, min, max, n}}} over replicates."""
    summary = {}
    for table_name, metrics in SUMMARY_METRICS.items():
        if table_name not in tables:
            continue
        table = pd.DataFrame(tables[table_name])
        if table_name == 'mix_results':
            true_cols = sorted(c for c in table.columns
                               if c.startswith('mix_true_'))
            pred_cols = sorted(c for c in table.columns
                               if c.startswith('mix_pred_'))
            table['mix_abs_error'] = np.abs(
                table[true_cols].values - table[pred_cols].values).mean(axis=1)
        table['config'] = table['sim_id'].map(_config_of)
        for config, group in table.groupby('config'):
            entry = summary.setdefault(config, {})
            for metric in metrics:
                if metric not in group:
                    continue
                values = group[metric].astype(float)
                entry[metric] = {
                    'mean': float(values.mean()),
                    'std': float(values.std(ddof=1)) if len(values) > 1
                    else 0.0,
                    'min': float(values.min()),
                    'max': float(values.max()),
                    'n': int(len(values)),
                }
    return summary


def main():
    store_filename, out_filename = sys.argv[1], sys.argv[2]

    out = {}
    with HDFStore(store_filename, 'r') as store:
        for key in ('/cn_evaluation', '/brk_cn_evaluation', '/mix_results',
                    '/outlier_evaluation', '/simulations'):
            if key not in store.keys():
                continue
            table = store[key]
            records = table.to_dict(orient='records')
            out[key.lstrip('/')] = [
                {k: (v.item() if isinstance(v, np.generic) else v)
                 for k, v in row.items()} for row in records]

    out['summary'] = summarize(out)

    with open(out_filename, 'w') as f:
        json.dump(out, f, indent=2, default=str)
    print('wrote', out_filename)


if __name__ == '__main__':
    sys.exit(main())
