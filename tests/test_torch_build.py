"""The port's kernel build names each library by a hash of what went into
it, so an edit rebuilds.  Every ``csrc/*.cuh`` header goes into every
target's hash: any source may include any header.  No ``nvcc`` is needed:
these tests only name targets, on a copy of ``csrc`` in ``tmp_path``."""
import shutil

import pytest
import torch

from repro_torch.kernels import build

torch.set_num_threads(1)  # xdist workers share the cores

SOURCES = sorted(p.name for p in build.CSRC.glob("*.cu"))
HEADERS = sorted(p.name for p in build.CSRC.glob("*.cuh"))


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    return dst


def test_targets_name_every_source_and_are_stable(csrc):
    first = build.targets(csrc)
    assert sorted(first) == sorted(s[:-3] for s in SOURCES)
    assert build.targets(csrc) == first
    assert first == build.targets()          # the copy hashes as the tree


@pytest.mark.parametrize("header", HEADERS)
def test_header_edit_changes_every_target(csrc, header):
    before = build.targets(csrc)
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = build.targets(csrc)
    assert all(after[name] != before[name] for name in before)


def test_new_header_changes_every_target(csrc):
    before = build.targets(csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = build.targets(csrc)
    assert all(after[name] != before[name] for name in before)


@pytest.mark.parametrize("source", SOURCES)
def test_source_edit_changes_only_its_target(csrc, source):
    before = build.targets(csrc)
    path = csrc / source
    path.write_text(path.read_text() + "\n// edited\n")
    after = build.targets(csrc)
    name = source[:-3]
    assert after[name] != before[name]
    assert {k: v for k, v in after.items() if k != name} == {
        k: v for k, v in before.items() if k != name}
