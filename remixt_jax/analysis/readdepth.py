"""Fit initialization machinery: read-depth modes and candidate haploid depths.

Capability parity with the reference init machinery
(/root/reference/remixt/analysis/readdepth.py:12-147): a per-segment depth
table restricted to usable segments, k-means modes of the length-weighted
minor-allele depth distribution, candidate monoclonal (normal, tumour)
haploid depth pairs, and a raw-copy-number ploidy estimate per candidate.
"""

import numpy as np
import sklearn.cluster

import remixt_jax.likelihood
import remixt_jax.utils


def calculate_depth(experiment):
    """Depth table: minor/major/total depth per segment with a
    ``high_quality`` indicator.

    A segment is high quality when its effective length, genotypable read
    count, and effective-to-genomic length ratio each clear the 10th
    percentile; rows where depths are undefined (zero effective length or
    zero genotypable proportion) are dropped.
    """
    x = np.asarray(experiment.x, dtype=float)
    l = np.asarray(experiment.l, dtype=float)
    genomic_span = (np.asarray(experiment.segment_end)
                    - np.asarray(experiment.segment_start) + 1)

    with np.errstate(invalid='ignore', divide='ignore'):
        allele_ratio = np.nan_to_num(x[:, 1] / (x[:, 0] + x[:, 1]))
        total = x[:, 2] / l
    minor = total * allele_ratio
    major = total * (1.0 - allele_ratio)

    quality_scores = {
        'length': l,
        'allele_readcount': x[:, 0] + x[:, 1],
        'length_ratio': l / genomic_span,
    }
    high_quality = np.ones(len(l), dtype=bool)
    for score in quality_scores.values():
        high_quality &= score > np.percentile(score, 10)

    phi = remixt_jax.likelihood.estimate_phi(x)
    measurable = remixt_jax.likelihood.proportion_measureable_matrix(phi)
    defined = (l > 0) & np.all(measurable > 0, axis=1)

    import pandas as pd
    table = pd.DataFrame({
        'chromosome': experiment.segment_chromosome_id,
        'start': experiment.segment_start,
        'end': experiment.segment_end,
        'length': l,
        'major': major,
        'minor': minor,
        'total': total,
        'high_quality': high_quality,
    })
    return table[defined]


def calculate_minor_modes(read_depth, num_clusters=5, min_cluster_prop=0.01,
                          return_masses=False):
    """Modes of the length-weighted minor-allele depth distribution.

    Depths above the 95th percentile (amplifications) are excluded, the
    remainder resampled proportional to segment length, clustered with
    k-means, and clusters holding under ``min_cluster_prop`` of the mass
    discarded. With ``return_masses`` also returns each surviving mode's
    mass fraction (modes sorted ascending).
    """
    minor = read_depth['minor'].values
    keep = minor < np.percentile(minor, 95)
    samples = remixt_jax.utils.weighted_resample(
        minor[keep], read_depth['length'].values[keep])[:, None]

    kmeans = sklearn.cluster.KMeans(n_clusters=num_clusters, n_init=10)
    assignment = kmeans.fit_predict(samples)
    proportion = np.bincount(
        assignment, minlength=num_clusters) / float(len(assignment))
    surviving = proportion >= min_cluster_prop
    modes = kmeans.cluster_centers_[surviving, 0]
    if not return_masses:
        return modes
    masses = proportion[surviving]
    order = np.argsort(modes)
    return modes[order], masses[order]


def calculate_candidate_h_monoclonal(minor_modes, h_normal=None,
                                     h_tumour=None, mode_masses=None,
                                     normal_mass_tolerance=0.05):
    """Candidate (normal, tumour) haploid depth pairs.

    The reference anchors the normal depth at the SMALLEST minor-depth
    mode (readdepth.py:90-124) — which latches onto spurious low-mass
    noise clusters under low tumour content (measured on the low-tumour
    accuracy benchmark: two of three replicates put a 1-4%-mass cluster
    below the true normal mode, poisoning every candidate). When
    ``mode_masses`` is given, every mode with at most
    ``normal_mass_tolerance`` of the distribution's mass strictly below
    it is tried as the normal anchor instead; the ELBO-based solution
    selection then arbitrates. ``normal_mass_tolerance=0`` (or no
    masses) reproduces the reference's smallest-mode rule.

    Per anchor, every higher mode yields two tumour-depth candidates —
    the mode offset itself, and half of it (the mode may correspond to
    two minor copies). Near-duplicate candidates are merged (2% rel).
    """
    minor_modes = np.asarray(minor_modes)
    if h_tumour is not None:
        if h_normal is None:
            h_normal = minor_modes.min()
        return np.array([[h_normal, h_tumour]])

    if h_normal is not None:
        anchors = [float(h_normal)]
    elif mode_masses is None or normal_mass_tolerance <= 0.0:
        anchors = [float(minor_modes.min())]
    else:
        order = np.argsort(minor_modes)
        modes_sorted = minor_modes[order]
        masses_sorted = np.asarray(mode_masses, dtype=float)[order]
        mass_below = np.concatenate([[0.0], np.cumsum(masses_sorted)[:-1]])
        anchors = [float(m) for m, below in zip(modes_sorted, mass_below)
                   if below <= normal_mass_tolerance]

    candidates = []
    for anchor in anchors:
        offsets = minor_modes[minor_modes > anchor] - anchor
        for offset in offsets:
            for scale in (1.0, 0.5):
                candidates.append(np.array([anchor, offset * scale]))

    deduped = []
    for cand in candidates:
        if not any(np.all(np.abs(cand - kept) <= 0.02 * np.abs(kept))
                   for kept in deduped):
            deduped.append(cand)
    return deduped


def estimate_ploidy(h, experiment):
    """Length-weighted mean total raw copy number under candidate ``h``."""
    depth = calculate_depth(experiment)
    h = np.asarray(h, dtype=float)

    raw_total = (depth['major'].values + depth['minor'].values
                 - 2.0 * h[0]) / h[1:].sum()
    length = depth['length'].values
    finite = np.isfinite(raw_total)
    return float((raw_total[finite] * length[finite]).sum()
                 / length[finite].sum())
