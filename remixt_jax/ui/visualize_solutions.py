"""``remixt-jax visualize_solutions``: interactive HTML report
(reference ui/visualize_solutions.py:10-11)."""

import remixt_jax.visualize


def create_visualization(**args):
    remixt_jax.visualize.create_solutions_visualization(args['results'], args['html'])


def add_arguments(argparser):
    argparser.add_argument('results',
        help='Results to visualize')

    argparser.add_argument('html',
        help='HTML output visualization')

    argparser.set_defaults(func=create_visualization)
