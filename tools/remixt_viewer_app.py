"""Results viewer server (parity with reference tools/remixt_viewer_app.py,
which served a bokeh app): generates the self-contained HTML solutions
report and serves it locally.

Usage: python tools/remixt_viewer_app.py results.h5 [--port 8000]
"""

import argparse
import http.server
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import remixt_jax.visualize


if __name__ == '__main__':
    argparser = argparse.ArgumentParser()
    argparser.add_argument('results', help='results HDF5 filename')
    argparser.add_argument('--port', type=int, default=8000)
    args = argparser.parse_args()

    serve_dir = tempfile.mkdtemp(prefix='remixt_jax_viewer_')
    html = os.path.join(serve_dir, 'index.html')
    remixt_jax.visualize.create_solutions_visualization(args.results, html)

    os.chdir(serve_dir)
    print(f'serving {html} at http://localhost:{args.port}/')
    http.server.HTTPServer(
        ('', args.port),
        http.server.SimpleHTTPRequestHandler).serve_forever()
