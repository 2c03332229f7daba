"""``remixt-jax write_results``: export the best solution's tables.

Capability parity with the reference's ``remixt write_results``
(/root/reference/remixt/ui/write_results.py:8-49): restarts are filtered
by divergent proportion and an optional ploidy window, the highest-ELBO
survivor's cn/brk_cn tables go to TSV, and its stats plus h/mix vectors go
to a metadata YAML.
"""

import numpy as np
import yaml

from remixt_jax.io.hdf5 import HDFStore


def _select_solution(stats, max_proportion_divergent, min_ploidy, max_ploidy):
    """Highest-ELBO restart among those passing the filters."""
    passing = stats[
        stats['proportion_divergent'] <= max_proportion_divergent]
    if max_ploidy is not None:
        passing = passing[passing['ploidy'] < max_ploidy]
    if min_ploidy is not None:
        passing = passing[passing['ploidy'] > min_ploidy]
    if passing.empty:
        raise ValueError('filters too restrictive, no solutions')
    return passing.loc[passing['elbo'].idxmax()]


def _as_plain_types(values):
    """YAML-safe dict: numpy scalars unwrapped to Python scalars."""
    return {key: value.item() if isinstance(value, np.generic) else value
            for key, value in values.items()}


def write_results_tables(**args):
    with HDFStore(args['results_filename'], 'r') as store:
        best = _select_solution(
            store['stats'], args['max_proportion_divergent'],
            args.get('min_ploidy'), args.get('max_ploidy'))
        solution_key = 'solutions/solution_{}'.format(best['init_id'])
        tables = {name: store['{}/{}'.format(solution_key, name)]
                  for name in ('cn', 'brk_cn', 'h', 'mix')}

    tables['cn'].to_csv(args['cn_filename'], sep='\t', index=False)
    tables['brk_cn'].to_csv(args['brk_cn_filename'], sep='\t', index=False)

    metadata = _as_plain_types(dict(best))
    metadata['h'] = list(tables['h'].tolist())
    metadata['mix'] = list(tables['mix'].tolist())
    with open(args['meta_filename'], 'w') as meta_file:
        yaml.dump(metadata, meta_file, default_flow_style=False)


def add_arguments(argparser):
    for name, help_text in (
            ('results_filename', 'Results filename'),
            ('cn_filename', 'Output segment copy number table filename'),
            ('brk_cn_filename',
             'Output breakpoint copy number table filename'),
            ('meta_filename', 'Output meta data filename')):
        argparser.add_argument(name, help=help_text)

    argparser.add_argument('--max_ploidy', type=float, default=None,
                           help='Maximum ploidy')
    argparser.add_argument('--min_ploidy', type=float, default=None,
                           help='Minimum ploidy')
    argparser.add_argument('--max_proportion_divergent', type=float,
                           default=0.5,
                           help='Maximum proportion of the genome divergent')
    argparser.set_defaults(func=write_results_tables)
