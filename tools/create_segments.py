"""Standalone segmentation tool (parity with reference tools/create_segments.py)."""

import argparse
import os
import sys

import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import remixt_jax.analysis.segment


if __name__ == '__main__':
    argparser = argparse.ArgumentParser()
    argparser.add_argument('ref_data_dir')
    argparser.add_argument('segment_filename')
    argparser.add_argument('--breakpoint_filename', default=None)
    argparser.add_argument('--config', default=None)
    args = argparser.parse_args()

    config = {}
    if args.config is not None:
        config = yaml.safe_load(open(args.config))

    remixt_jax.analysis.segment.create_segments(
        args.segment_filename, config, args.ref_data_dir,
        breakpoint_filename=args.breakpoint_filename)
