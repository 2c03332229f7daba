"""Layered configuration access.

Semantics parity with /root/reference/remixt/config.py:5-59: module-level
defaults (defaults.py) overlaid by the user's YAML dict, ``*_filename``
overrides taking precedence over ``*_template`` expansion against the full
config plus ``ref_data_dir``, and per-sample overrides nested under the
``sample_specific`` key.
"""

import remixt_jax.defaults


def _default_params():
    return {name: value
            for name, value in vars(remixt_jax.defaults).items()
            if not name.startswith('_')}


def get_full_config(config):
    """Defaults overlaid with the user config (user wins)."""
    return {**_default_params(), **config}


def get_param(config, name):
    """One parameter, user value or default; KeyError when unknown."""
    if name in config:
        return config[name]
    return _default_params()[name]


def get_filename(config, ref_data_dir, name, **kwargs):
    """Resolve a reference-data filename.

    ``<name>_filename`` in the config wins outright; otherwise
    ``<name>_template`` is format-expanded against the full config,
    ``ref_data_dir`` and any extra keyword fields (e.g. chromosome).
    """
    full = get_full_config(config)
    if name + '_filename' in full:
        return full[name + '_filename']
    template = full.get(name + '_template')
    if template is not None:
        return template.format(**{**full, **kwargs,
                                  'ref_data_dir': ref_data_dir})
    return None


def get_chromosome_lengths(config, ref_data_dir):
    """Configured chromosomes with their FASTA-index lengths; validates the
    configured set and its chr-prefix convention against the index."""
    import remixt_jax.utils

    lengths = remixt_jax.utils.read_chromosome_lengths(
        get_filename(config, ref_data_dir, 'genome_fai'))

    wanted = set(get_param(config, 'chromosomes'))
    missing = wanted - set(lengths)
    assert not missing, 'chromosomes {} absent from genome index'.format(
        sorted(missing))

    prefix = get_param(config, 'chr_name_prefix')
    prefixed = {c for c in wanted if str(c).startswith('chr')}
    if prefix == 'chr':
        assert prefixed == wanted
    elif prefix == '':
        assert not prefixed
    else:
        raise ValueError(
            'unrecognized chr_name_prefix {}'.format(prefix))

    return {chromosome: length for chromosome, length in lengths.items()
            if chromosome in wanted}


def get_chromosomes(config, ref_data_dir):
    """Configured chromosome names, in genome-index order."""
    return list(get_chromosome_lengths(config, ref_data_dir).keys())


def get_sample_config(config, sample_id):
    """Config with this sample's ``sample_specific`` overrides applied."""
    merged = dict(config)
    merged.update(config.get('sample_specific', {}).get(sample_id, {}))
    return merged
