"""Summarize a JAX profiler trace: top HLO ops by device time.

Parses the xplane.pb written by tools/profile_engine.py with the local
xprof/tensorboard-plugin-profile converter (no TensorBoard server) and
prints a table of the heaviest ops with their memory-bandwidth and
boundedness columns — the attribution step of the measure-first loop.

Usage:
    python tools/summarize_trace.py /tmp/remixt_jax_trace [--top 30]
"""

import argparse
import glob
import json
import os


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('trace_dir')
    ap.add_argument('--top', type=int, default=30)
    args = ap.parse_args()

    paths = sorted(glob.glob(os.path.join(
        args.trace_dir, 'plugins', 'profile', '*', '*.xplane.pb')))
    if not paths:
        raise SystemExit('no xplane.pb under ' + args.trace_dir)
    from xprof.convert import raw_to_tool_data as rtd
    data, _ = rtd.xspace_to_tool_data([paths[-1]], 'hlo_stats', {})
    if isinstance(data, bytes):
        data = data.decode()
    d = json.loads(data)
    cols = [c['id'] for c in d['cols']]
    i = {c: k for k, c in enumerate(cols)}
    rows = [[c['v'] for c in r['c']] for r in d['rows']]
    # self-time, not total_time: wrapper ops (`while` scan bodies) report
    # the whole nested body as total_time, double-counting every leaf op
    rows.sort(key=lambda v: -v[i['total_self_time']])
    tot = sum(v[i['total_self_time']] for v in rows)
    print('device total: {:.1f} us'.format(tot))
    print(f"{'us':>9} {'%':>5} {'occ':>4} {'GB/s':>6} {'bound':>10}  op")
    for v in rows[:args.top]:
        frm = str(v[i['tf_op_name']]).replace('jit(<unknown>)/', '')[:58]
        print(f"{v[i['total_self_time']]:9.1f} {100 * v[i['total_self_time']] / tot:5.1f}"
              f" {v[i['occurrences']]:4.0f} {v[i['measured_memory_bw']]:6.0f}"
              f" {str(v[i['bound_by']])[:10]:>10}"
              f"  {v[i['category']][:14]:14s} {frm}")


if __name__ == '__main__':
    main()
