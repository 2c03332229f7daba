"""chip_smoke.py's four-card phases rehearsed on four virtual CPU devices
at a tiny size."""

import jax

from test_chip_smoke import _tiny

import chip_smoke


def test_four_card_grid():
    sample, _, config, grid = _tiny()
    assert chip_smoke.four_card_grid(
        sample, grid, config, jax.devices()[:4]) == []


def test_four_card_cohort():
    sample, data, config, _ = _tiny()
    samples = chip_smoke.cohort_samples(
        sample, data, config, config['restart_chunk_size'], 2)
    assert len({id(s) for s, _, _ in samples.values()}) == 2
    assert chip_smoke.four_card_cohort(
        samples, config, jax.devices()[:4]) == []


def test_four_card_blocked_chain():
    assert chip_smoke.four_card_blocked_chain(
        jax.devices()[:4], 0, N=24, num_events=2, max_copy_number=3) == []
