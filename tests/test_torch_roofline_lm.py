"""A dry-run record of every LM cell on a ``(data=2, model=4)`` layout
(``launch.dryrun.run_cell``; the other families and the roofline's
units: ``test_torch_roofline.py``): status ok, the reference's record
keys, and ``0 < useful_ratio <= 1.05`` -- a ratio above 1 would mean a
kernel's work went uncounted."""
from __future__ import annotations

import pytest

from repro_torch.configs import cells, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import layout_mesh
from test_torch_roofline import MESH, hold_record

LM_CELLS = [(a, s) for a, s, _ in cells() if get_config(a).family == "lm"]


@pytest.mark.parametrize("arch,shape", LM_CELLS,
                         ids=[f"{a}-{s}" for a, s in LM_CELLS])
def test_dryrun_record(tmp_path, arch, shape):
    rec = run_cell(arch, shape, "2x4", str(tmp_path), mesh=layout_mesh(MESH))
    hold_record(rec, arch, shape)
    assert rec["roofline"]["coll_bytes"] > 0       # TP collectives seen
    if "decode" in shape or "500k" in shape:
        assert "full cache" in rec["port_notes"]
