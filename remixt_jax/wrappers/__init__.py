"""Competitor tool wrappers for benchmark comparison.

Mirrors /root/reference/remixt/wrappers/__init__.py's catalog of Tool
classes (remixt/titan/theta/clonehd). Each wrapper exposes
``create_workflow(seqdata_filenames, breakpoints, results, workdir,
normal_id)`` returning a scheduler Workflow that produces a results store in
the common schema consumed by the evaluation suite. External tools require
their binaries on PATH; their wrappers raise informative errors otherwise.
"""

from remixt_jax.wrappers.wrapremixt import ReMixTTool
from remixt_jax.wrappers.wrapexternal import TitanTool, ThetaTool, CloneHDTool

catalog = dict()
catalog['remixt'] = ReMixTTool
catalog['titan'] = TitanTool
catalog['theta'] = ThetaTool
catalog['clonehd'] = CloneHDTool
