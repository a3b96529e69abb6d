"""Allocate's body, free of any transport: what a container granted a set
of vdevices gets — env vars, mounts, device nodes and annotations.

``vtpu``'s ``_fill_allocate_response`` (plugin/server.py:380-589), key for
key, with these substitutions for an NVIDIA card under the port's
interposer:

- visibility: ``NVIDIA_VISIBLE_DEVICES``, the container runtime's name
  (reference server.go:469-471), with the card UUIDs (indices under
  ``--device-id-strategy=index``), or the MIG UUIDs of a ``core`` grant;
  under ``--device-list-strategy=device-specs`` the runtime's
  volume-mounts form instead (one /dev/null mount per device under
  ``NVIDIA_DEVICE_LIST_DIR``, reference server.go:565-581);
- ``VTPU_DEVICE_HBM_LIMIT_<i>``, ``VTPU_DEVICE_MAP``,
  ``VTPU_DEVICE_CORE_LIMIT``, ``VTPU_DEVICE_MEMORY_SHARED_CACHE`` and
  ``VTPU_OVERSUBSCRIBE`` as ``vtpu`` writes them, and
  ``VTPU_CORE_UTILIZATION_POLICY=FORCE`` on every time-shared grant: the
  port has no broker, so every grant is ``vtpu``'s interposer-only path
  (server.py:446-460);
- no ``VTPU_MIN_EXEC_COST_US`` unless the daemon's env sets one (the
  H100 has no default floor, ``utils/envspec.py``);
- the interposer: ``libvtpu_cuda.so`` mounted at /usr/local/vtpu/ and a
  one-line ``ld.so.preload`` over /etc/ld.so.preload (reference
  server.go:511-515), in place of ``TPU_LIBRARY_PATH`` and the
  libvtpu_pjrt/libvtpu_preload mounts; mounted only when both staged host
  files exist (a bind mount with a missing source fails container
  creation), and otherwise refused with an error in the log;
- on a time-shared grant, each granted card's busy file, which the
  daemon made at start (``stage_busy_files``), mounted read-write on its
  own at /usr/local/vtpu/busy/<card uuid>.busy, the directory named by
  ``VTPU_DEVICE_BUSY_DIR``: there the interposers of every pod on the card
  share its time slices.  No pod gets a directory it could plant files
  in, and a MIG instance, which runs beside the others and not in turns
  with them, gets none;
- device nodes under ``--pass-device-specs``: /dev/nvidia<minor>,
  /dev/nvidiactl, /dev/nvidia-uvm, /dev/nvidia-uvm-tools;
- the in-container bootstrap, each part mounted only when its staged
  source exists (``stage_shim``): the shim directory at
  /usr/local/vtpu/shim (``sitecustomize.py``, ``vtpu_smi_lite.py`` and a
  copy of the package), ``libvtpucore.so`` beside it, and
  ``vtpu_smi_lite.py`` as /usr/local/vtpu/vtpu-smi.  With the shim,
  ``VTPU_SHIM_PYTHONPATH`` names its entry and ``PYTHONPATH`` is that
  entry, followed by the PYTHONPATH the matched pod declares (monitor
  mode) and then ``VTPU_PYTHONPATH_MERGED=1`` (vtpu server.py:474-503).
  Without the shim no PYTHONPATH is set: it would only replace the
  image's.  ``VTPU_EXTRA_PYTHONPATH``, set on the pod spec, is not
  touched;
- monitor mode (``--monitor-mode``), when the pod was matched: the
  region is /usr/local/vtpu/shared/<ns>_<pod>_<ctr>_<uid8>/vtpushr.cache,
  for the node's monitor to read (vtpu server.py:280-307), and only that
  pod's own directory of the host's shared/ is mounted, read-write, at
  the same container path; ``vtpu`` mounts the whole shared/ into every
  pod, where each pod could read or plant files in every other pod's;
- the legacy controller (``--enable-legacy-preferred``): the annotations
  ``4paradigm.com/vtpu-request`` (the kubelet's IDs) and
  ``4paradigm.com/vtpu-using`` (the vdevices granted), from which it
  rebuilds ownership out of the kubelet's checkpoint.  ``vtpu`` writes
  the granted IDs under both, so the checkpoint loses the request.

- metricsd (``--enable-metricsd``): ``VTPU_METRICSD_PORT``, the port
  the bootstrap's metricsd binds in the container, as ``vtpu`` sets it
  (server.py:505-515).  ``vtpu`` also moves libtpu's own metrics service
  to the port plus an offset (``TPU_RUNTIME_METRICS_PORTS``, a libtpu
  variable) and names it as metricsd's upstream
  (``VTPU_METRICSD_UPSTREAM``): a CUDA node runs no such service, so
  neither is emitted.

Not emitted until the grant's broker half is ported (ROADMAP.md, Queue 1
item 6(e), the bridge): the runtime socket.  Never emitted on the H100: the env-override marker of
the PJRT preload library.
"""

from __future__ import annotations

import os
import shutil
import stat
import uuid as uuidlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

from ..ops import _build
from ..shim.interposer import BUSY_FILE_BYTES
from ..utils import envspec
from ..utils import logging as log
from .config import Config
from .split import PluginSpec
from .vdevice import VDevice

# Container-side install prefix (the reference mounts into
# /usr/local/vgpu, server.go:511-522).
CONTAINER_LIB_DIR = "/usr/local/vtpu"
INTERPOSER = "libvtpu_cuda.so"
PRELOAD_LIST = "ld.so.preload"
BUSY_DIR = "busy"
CONTAINER_BUSY_DIR = os.path.join(CONTAINER_LIB_DIR, BUSY_DIR)
PCIBUS_NAME = "pciinfo.vtpu"
# The in-container bootstrap, staged by stage_shim.
SHIM_DIR = "shim"
CORE_LIB = "libvtpucore.so"
SMI_SCRIPT = "vtpu_smi_lite.py"
SMI_MOUNT = "vtpu-smi"
# Monitor mode's per-pod regions: <SHARED_DIR>/<name>/<REGION_NAME>.
SHARED_DIR = "shared"
REGION_NAME = "vtpushr.cache"
# The legacy controller's annotations (reference
# vdevice-controller.go:25-29).
ANNOTATION_REQUEST = "4paradigm.com/vtpu-request"
ANNOTATION_USING = "4paradigm.com/vtpu-using"


@dataclass
class Mount:
    container_path: str
    host_path: str
    read_only: bool


@dataclass
class DeviceSpec:
    container_path: str
    host_path: str
    permissions: str = "rw"


@dataclass
class PodMatch:
    """The pending pod's container that an Allocate serves, as monitor
    mode matched it: its identity and the env it declares (plain
    name/value entries)."""
    namespace: str
    pod: str
    container: str
    uid: str
    env: Dict[str, str] = field(default_factory=dict)

    @property
    def shared_name(self) -> str:
        """Its directory under shared/: namespace and UID keep distinct
        pods of one name apart."""
        return f"{self.namespace}_{self.pod}_{self.container}_{self.uid[:8]}"


@dataclass
class Grant:
    envs: Dict[str, str] = field(default_factory=dict)
    mounts: List[Mount] = field(default_factory=list)
    devices: List[DeviceSpec] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)


def _visible(cfg: Config, vdevs: Sequence[VDevice]) -> List[str]:
    """The container runtime's device tokens for the grant, deduped."""
    out: List[str] = []
    for v in vdevs:
        if v.mig is not None:
            tok = (f"{v.chip.index}:{v.mig.index}"
                   if cfg.device_id_strategy == "index" else v.mig.uuid)
        else:
            tok = (str(v.chip.index) if cfg.device_id_strategy == "index"
                   else v.chip_uuid)
        if tok not in out:
            out.append(tok)
    return out


def grant(cfg: Config, spec: PluginSpec, vdevs: Sequence[VDevice],
          ids: Sequence[str], pod_env: Optional[Mapping[str, str]] = None,
          shared_name: Optional[str] = None,
          annotate: bool = False) -> Grant:
    """What Allocate answers for one container granted ``vdevs`` for the
    kubelet's ``ids``: the same vdevices, or the ones the legacy
    controller picked in their place, which ``annotate`` records.
    ``pod_env`` is what the matched pod declares (its PYTHONPATH is
    merged behind the shim's entry), and ``shared_name`` the pod's
    directory under the host's shared/, made already, that holds its
    region in monitor mode."""
    g = Grant()
    envs = g.envs
    visible = _visible(cfg, vdevs)
    device_list_mounts = []
    if cfg.device_list_strategy == "device-specs":
        envs[envspec.ENV_NVIDIA_VISIBLE_DEVICES] = \
            envspec.NVIDIA_DEVICE_LIST_DIR
        device_list_mounts = [
            Mount(os.path.join(envspec.NVIDIA_DEVICE_LIST_DIR, tok),
                  "/dev/null", True) for tok in visible]
    else:
        envs[envspec.ENV_NVIDIA_VISIBLE_DEVICES] = ",".join(visible)

    # Ordinal -> physical card, and per-ordinal HBM caps (reference
    # server.go:486-493).
    map_entries = []
    for i, v in enumerate(vdevs):
        map_entries.append(f"{i}:{v.chip_uuid}")
        if v.hbm_bytes > 0:
            envs[f"{envspec.ENV_HBM_LIMIT}_{i}"] = \
                envspec.format_quantity_mb(v.hbm_bytes)
    envs[envspec.ENV_DEVICE_MAP] = " ".join(map_entries)

    # Compute quota: time-shared splits only (reference
    # CUDA_DEVICE_SM_LIMIT, server.go:492).
    if spec.time_shared and vdevs and vdevs[0].core_pct > 0:
        envs[envspec.ENV_CORE_LIMIT] = str(vdevs[0].core_pct)
        floor = os.environ.get(envspec.ENV_MIN_EXEC_COST,
                               envspec.min_exec_cost_default(
                                   vdevs[0].chip.model))
        if floor is not None:
            envs[envspec.ENV_MIN_EXEC_COST] = floor

    core_ids = [str(v.core_index) for v in vdevs if v.core_index is not None]
    if core_ids:
        envs["VTPU_CORE_INDICES"] = ",".join(core_ids)

    # Each Allocate gets a private region (in monitor mode, in the pod's
    # own directory); co-tenants of a card meet in its busy file instead.
    shared_dir = (os.path.join(CONTAINER_LIB_DIR, SHARED_DIR, shared_name)
                  if shared_name else None)
    envs[envspec.ENV_SHARED_CACHE] = (
        os.path.join(shared_dir, REGION_NAME) if shared_dir
        else f"/tmp/vtpu_{uuidlib.uuid4().hex[:12]}.cache")
    if cfg.oversubscribe:
        envs[envspec.ENV_OVERSUBSCRIBE] = "true"
    if spec.time_shared:
        # Each region is private, so the DEFAULT policy's probe would see
        # this pod's processes alone and never gate; FORCE always does.
        # An operator env on the daemon still wins.
        envs[envspec.ENV_UTILIZATION_POLICY] = os.environ.get(
            envspec.ENV_UTILIZATION_POLICY, "FORCE")
    if cfg.pcibus_file:
        envs[envspec.ENV_PCIBUS_FILE] = os.path.join(CONTAINER_LIB_DIR,
                                                     PCIBUS_NAME)
    if cfg.enable_metricsd:
        envs["VTPU_METRICSD_PORT"] = str(cfg.metricsd_port)

    host = cfg.host_lib_dir
    shim = os.path.join(host, SHIM_DIR)
    if os.path.isdir(shim):
        shim_pp = os.path.join(CONTAINER_LIB_DIR, SHIM_DIR)
        envs[envspec.ENV_SHIM_PYTHONPATH] = shim_pp
        user_pp = (pod_env or {}).get("PYTHONPATH", "")
        envs["PYTHONPATH"] = (shim_pp + os.pathsep + user_pp if user_pp
                              else shim_pp)
        if user_pp:
            envs[envspec.ENV_PYTHONPATH_MERGED] = "1"
        log.info("allocate: PYTHONPATH=%s (%s)", envs["PYTHONPATH"],
                 "the pod's own entries kept after the shim" if user_pp
                 else "replaces an image-ENV PYTHONPATH; a pod names such "
                 "entries in VTPU_EXTRA_PYTHONPATH")
    else:
        log.warn("allocate: %s is not staged; no in-container bootstrap "
                 "for this container", shim)
    for cpath, hpath in ((os.path.join(CONTAINER_LIB_DIR, CORE_LIB),
                          os.path.join(host, CORE_LIB)),
                         (os.path.join(CONTAINER_LIB_DIR, SHIM_DIR), shim),
                         (os.path.join(CONTAINER_LIB_DIR, SMI_MOUNT),
                          os.path.join(shim, SMI_SCRIPT))):
        if os.path.exists(hpath):
            g.mounts.append(Mount(cpath, hpath, True))
    lib = os.path.join(host, INTERPOSER)
    preload = os.path.join(host, PRELOAD_LIST)
    if os.path.exists(lib) and os.path.exists(preload):
        g.mounts.append(Mount(os.path.join(CONTAINER_LIB_DIR, INTERPOSER),
                              lib, True))
        g.mounts.append(Mount("/etc/ld.so.preload", preload, True))
    else:
        log.error("allocate: %s or %s is not staged; REFUSING to mount the "
                  "interposer: this container runs unenforced", lib, preload)
    if cfg.pcibus_file:
        g.mounts.append(Mount(os.path.join(CONTAINER_LIB_DIR, PCIBUS_NAME),
                              cfg.pcibus_file, True))
    if shared_dir:
        g.mounts.append(Mount(shared_dir, os.path.join(host, SHARED_DIR,
                                                       shared_name), False))
    if spec.time_shared:
        for u in dict.fromkeys(v.chip_uuid for v in vdevs):
            path = os.path.join(host, BUSY_DIR, f"{u}.busy")
            if os.path.isfile(path) and not os.path.islink(path):
                g.mounts.append(Mount(os.path.join(CONTAINER_BUSY_DIR,
                                                   f"{u}.busy"), path, False))
                envs[envspec.ENV_DEVICE_BUSY_DIR] = CONTAINER_BUSY_DIR
            else:
                log.error("allocate: %s is not staged; REFUSING to mount it: "
                          "this container's tenants will bill their "
                          "co-tenants' time on card %s as their own", path, u)
    g.mounts.extend(device_list_mounts)

    if cfg.pass_device_specs:
        seen = set()
        for v in vdevs:
            for p in v.chip.device_paths:
                if p not in seen:
                    seen.add(p)
                    g.devices.append(DeviceSpec(p, p, "rw"))
    if annotate:
        g.annotations[ANNOTATION_REQUEST] = ",".join(ids)
        g.annotations[ANNOTATION_USING] = ",".join(v.id for v in vdevs)
    return g


def staged_files(host_lib_dir: str, library: str) -> Dict[str, str]:
    """Stage the interposer ``library`` and its one-line ld.so.preload
    list in ``host_lib_dir`` (what a node's install step does); returns
    the staged paths by name."""
    os.makedirs(host_lib_dir, exist_ok=True)
    lib = os.path.join(host_lib_dir, INTERPOSER)
    if os.path.realpath(library) != os.path.realpath(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        with open(library, "rb") as src, open(tmp, "wb") as dst:
            dst.write(src.read())
        os.replace(tmp, lib)
    preload = os.path.join(host_lib_dir, PRELOAD_LIST)
    with open(preload, "w") as f:
        f.write(os.path.join(CONTAINER_LIB_DIR, INTERPOSER) + "\n")
    return {INTERPOSER: lib, PRELOAD_LIST: preload}


def _copy_file(src: str, dst: str) -> None:
    """Copy ``src`` to ``dst`` through a temporary name, so that a reader
    never finds half a file."""
    tmp = f"{dst}.{os.getpid()}.tmp"
    shutil.copyfile(src, tmp)
    os.chmod(tmp, 0o644)
    os.replace(tmp, dst)


def stage_shim(host_lib_dir: str) -> Dict[str, str]:
    """Stage the in-container bootstrap in ``host_lib_dir`` (what a node's
    install step does, beside ``staged_files``): ``shim/`` holding
    ``sitecustomize.py``, ``vtpu_smi_lite.py`` and a self-contained copy
    of this package as ``vtpu_torch/`` (a real directory: the source
    tree's alias package points at a sibling a container does not have;
    no native tests or mocks, no build output), and ``libvtpucore.so``
    from the port's own build, which the copy loads from beside its shim
    directory.  A shim staged before is replaced whole.  Returns the
    staged paths by name."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(host_lib_dir, exist_ok=True)
    shim = os.path.join(host_lib_dir, SHIM_DIR)
    tmp = f"{shim}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(pkg, os.path.join(tmp, "vtpu_torch"),
                    ignore=shutil.ignore_patterns(
                        "__pycache__", "*.pyc", "*_test.cc", "mock_cuda.cc",
                        "build*"))
    for name in ("sitecustomize.py", SMI_SCRIPT):
        shutil.copyfile(os.path.join(pkg, "shim", name),
                        os.path.join(tmp, name))
    old = f"{shim}.{os.getpid()}.old"
    if os.path.exists(shim):
        os.rename(shim, old)
    os.rename(tmp, shim)
    shutil.rmtree(old, ignore_errors=True)
    core = os.path.join(host_lib_dir, CORE_LIB)
    _copy_file(_build.build_all(("vtpucore",))["vtpucore"], core)
    return {SHIM_DIR: shim, CORE_LIB: core,
            SMI_MOUNT: os.path.join(shim, SMI_SCRIPT)}


def stage_busy_files(host_lib_dir: str, card_uuids: Sequence[str]) -> List[str]:
    """Make each card's busy file, ``<host_lib_dir>/busy/<uuid>.busy``, at
    full size and writable by every tenant's user, in a directory only the
    daemon writes (what the daemon does at start).  A file kept from an
    earlier start keeps its slots; a symlink is refused, never followed.
    Returns the paths."""
    d = os.path.join(host_lib_dir, BUSY_DIR)
    os.makedirs(d, exist_ok=True)
    os.chmod(d, 0o755)
    paths = []
    for u in card_uuids:
        if not u or u in (".", "..") or "/" in u:
            raise ValueError(f"card UUID {u!r} cannot name a busy file")
        path = os.path.join(d, f"{u}.busy")
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_NOFOLLOW
                     | os.O_CLOEXEC, 0o666)
        try:
            st = os.fstat(fd)
            if not stat.S_ISREG(st.st_mode):
                raise OSError(f"{path} is not a regular file")
            if st.st_size < BUSY_FILE_BYTES:
                os.ftruncate(fd, BUSY_FILE_BYTES)
            os.fchmod(fd, 0o666)
        finally:
            os.close(fd)
        paths.append(path)
    return paths
