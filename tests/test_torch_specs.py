"""``launch.specs.build_cell`` against the reference's on all 36 cells
of a ``(data=2, model=4)`` mesh: kind, every argument's global shape and
dtype, every partition spec (in and out), ``donate_argnums``,
``model_flops`` (equal) and ``notes``.  The reference runs once, in a
subprocess with 8 jax host devices; the port's cells are built on a
layout mesh of the same shape (rank 0, no process joins)."""
from __future__ import annotations

import pytest

from repro_torch.configs import cells
from repro_torch.launch.mesh import layout_mesh
from repro_torch.launch.specs import build_cell
from torch_specs_common import assert_same_cell, port_cell, reference_cells

CELLS = [(a, s) for a, s, _ in cells()]


@pytest.fixture(scope="module")
def reference():
    return reference_cells((2, 4), ("data", "model"), CELLS)


def test_grid_is_the_references():
    assert len(CELLS) == 36


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_equals_reference(reference, arch, shape):
    mesh = layout_mesh((2, 4))
    assert_same_cell(port_cell(build_cell(arch, shape, mesh)),
                     reference[f"{arch}|{shape}"])
