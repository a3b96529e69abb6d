"""The port's ctypes mirrors of the shared region against the C header.

``vtpu_torch.shim.core`` mirrors ``vtpu_device_stats``,
``vtpu_proc_stats`` and ``VTPU_MAX_PROCS`` of
``native/vtpucore/vtpu_core.h`` (``MAX_DEVICES_PER_NODE`` of the port's
``utils/envspec.py`` mirrors ``VTPU_MAX_DEVICES``).  A field out of order
or of the wrong width reads the wrong bytes of a region that ``vtpu``'s
tools share, and nothing at run time notices.  The header's own
``mirror:`` declarations name the pairs; ``vtpu``'s atomics checker
(``tools/analyze/atomics.py``) holds its package's mirrors to them, and
this file runs the same parsers and layout engines over the port's
sources: field names, order, offsets and sizes, and the constants.
"""

import dataclasses
import os
import re

import pytest

from vtpu.tools.analyze import atomics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "4paradigm-k8s-device-plugin_tpu_torch")
CORE = os.path.join(PORT, "shim", "core.py")
ENVSPEC = os.path.join(PORT, "utils", "envspec.py")

# The mirrors the port has today; each must be checked.
PORT_MIRRORS = {"DeviceStats", "ProcStats"}
PORT_CONSTS = {"MAX_DEVICES_PER_NODE", "MAX_PROCS"}


def _read(path):
    with open(path) as f:
        return f.read()


def mirror_drift(core_src, envspec_src):
    """(findings, checked classes, checked constants) for the port's
    sources against vtpu_core.h."""
    header = _read(os.path.join(REPO, atomics.HEADER))
    gt, findings = atomics.parse_ground_truth(header)
    assert gt is not None and not findings, findings
    structs, defines = atomics.parse_c_structs(
        {atomics.HEADER: atomics.strip_comments(header)})
    consts = {"core": core_src, "envspec": envspec_src}
    py_structs, py_consts = atomics.parse_ctypes_structs(core_src, consts)
    # The header also declares mirrors of later slices (trace ring, exec
    # ring); hold the port to those its sources define.
    port_gt = dataclasses.replace(
        gt,
        mirrors=[m for m in gt.mirrors if m[2] in py_structs],
        consts=[c for c in gt.consts if c[2] in py_consts])
    out = atomics.check_mirrors(port_gt, structs, defines, core_src, consts)
    return ([f.message for f in out], {m[2] for m in port_gt.mirrors},
            {c[2] for c in port_gt.consts})


def test_port_mirrors_match_header():
    found, classes, names = mirror_drift(_read(CORE), _read(ENVSPEC))
    assert found == []
    assert classes >= PORT_MIRRORS and names >= PORT_CONSTS


def test_layouts_agree_field_by_field():
    """The layout engines themselves, side by side, for the two
    structs: the same (name, offset, size) rows."""
    header = atomics.strip_comments(_read(os.path.join(REPO,
                                                       atomics.HEADER)))
    structs, _ = atomics.parse_c_structs({atomics.HEADER: header})
    core = _read(CORE)
    py, _ = atomics.parse_ctypes_structs(core, {"core": core,
                                                "envspec": _read(ENVSPEC)})
    for cname, pyname in (("vtpu_device_stats", "DeviceStats"),
                          ("vtpu_proc_stats", "ProcStats")):
        c = atomics.c_layout(cname, structs)
        assert c and c == atomics.ctypes_layout(py[pyname]), cname


def _swap_lines(src, first, second):
    lines = src.splitlines(keepends=True)
    i = next(n for n, ln in enumerate(lines) if first in ln)
    j = next(n for n, ln in enumerate(lines) if second in ln)
    lines[i], lines[j] = lines[j], lines[i]
    return "".join(lines)


@pytest.mark.parametrize("name,edit,expect", [
    ("reordered field",
     lambda s: _swap_lines(s, '("used_bytes", ctypes.c_uint64),',
                           '("peak_bytes", ctypes.c_uint64),'),
     "DeviceStats ctypes fields"),
    ("widened field",
     lambda s: s.replace('("core_limit_pct", ctypes.c_int32)',
                         '("core_limit_pct", ctypes.c_int64)'),
     "vtpu_device_stats.core_limit_pct"),
    ("array extent",
     lambda s: re.sub(r"MAX_PROCS = \d+", "MAX_PROCS = 32", s),
     "VTPU_MAX_PROCS"),
])
def test_seeded_drift_is_caught(name, edit, expect):
    core = _read(CORE)
    drifted = edit(core)
    assert drifted != core, name
    found, _, _ = mirror_drift(drifted, _read(ENVSPEC))
    assert any(expect in f and "DRIFT" in f for f in found), (name, found)


def test_envspec_extent_drift_is_caught():
    envspec = _read(ENVSPEC)
    drifted = re.sub(r"MAX_DEVICES_PER_NODE = \d+",
                     "MAX_DEVICES_PER_NODE = 8", envspec)
    assert drifted != envspec
    found, _, _ = mirror_drift(_read(CORE), drifted)
    assert any("VTPU_MAX_DEVICES" in f for f in found), found
    assert any("ProcStats" in f or "vtpu_proc_stats" in f for f in found)
