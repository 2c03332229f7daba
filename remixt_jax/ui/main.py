"""``remixt-jax`` console entry point.

Subcommand dispatcher mirroring the reference CLI
(/root/reference/remixt/ui/main.py:15-20): run, create_ref_data,
mappability_bwa, write_results, plot_results, visualize_solutions — plus
``fit`` (count-table to results without BAM preprocessing, the minimum
end-to-end slice).
"""

import argparse

import remixt_jax.ui.run
import remixt_jax.ui.fit
import remixt_jax.ui.create_ref_data
import remixt_jax.ui.mappability_bwa
import remixt_jax.ui.write_results
import remixt_jax.ui.plot_results
import remixt_jax.ui.visualize_solutions


def main():
    argparser = argparse.ArgumentParser(prog='remixt-jax')
    subparsers = argparser.add_subparsers(required=True)

    modules = {
        'run': remixt_jax.ui.run,
        'fit': remixt_jax.ui.fit,
        'create_ref_data': remixt_jax.ui.create_ref_data,
        'mappability_bwa': remixt_jax.ui.mappability_bwa,
        'write_results': remixt_jax.ui.write_results,
        'plot_results': remixt_jax.ui.plot_results,
        'visualize_solutions': remixt_jax.ui.visualize_solutions,
    }

    for name, module in modules.items():
        subparser = subparsers.add_parser(name)
        module.add_arguments(subparser)

    args = vars(argparser.parse_args())
    func = args.pop('func')
    # the fit paths turn on the compilation cache once they have read the
    # config, which may turn it off (analysis/pipeline.py)
    func(**args)


if __name__ == '__main__':
    main()
