"""remixt_jax — a JAX framework for joint clone-specific segment and
breakpoint copy-number inference from tumour whole-genome sequencing data.

This is a ground-up JAX/XLA re-design with the capabilities of ReMixT
(reference: amcpherson/remixt; see /root/reference). The computational core —
structured variational EM over an HMM whose states are clone×allele copy-number
tuples with breakpoint factors coupling non-adjacent segments — is expressed as
batched XLA element-wise likelihood kernels, matmul-shaped transition-bank
contractions, and scan-based forward-backward, with restart and chain axes
sharded over a `jax.sharding.Mesh`.

Layer map (mirrors reference layers, re-architected for a device mesh):
  io/          seqdata store (HDF5 via h5py), BAM allele reader binding
  utils/       genomic interval algorithms (segalg), misc utilities
  analysis/    data prep: segments, readcount, gcbias, stats, readdepth,
               haplotype, breakpoints, experiment, fit pipeline
  models/      the inference core: state enumeration, variational engine,
               EM drivers, numpy float64 oracle (spec + test reference)
  ops/         forward-backward scans (chain-batched, blocked), special
               functions
  parallel/    device-mesh sharding: restart fan-out, chain-sharded scans
  simulations/ genome simulation, read sampling, evaluation metrics
  ui/          command-line interface
"""

__version__ = "0.1.0"
