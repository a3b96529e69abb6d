"""What the fastlane's spin waits cost the broker's host.

A lane's waits spin for ``VTPU_FASTLANE_SPIN_US`` (200 µs by default),
yielding the core, before they sleep on the ring's futex word: the
client's wait for a completion and the broker's drainer, which waits on
an idle lane's tail 20 ms at a time.  This tool starts a broker process
with a given spin, then ``n`` lane tenants (each its own process, with
the same spin and no card of its own), and reads, over two windows of
``--seconds``:

- **idle**: every tenant connected, its route bound, sending nothing;
- **busy**: every tenant sending synchronous executes of a 256-float
  program, one at a time, each waiting for its completion.

For each window it reports the broker's CPU (cores: user + system time
over the window, from ``/proc/<pid>/stat``), its wakeups a second (the
voluntary and involuntary context switches of all its threads, from
``/proc/<pid>/task/*/status``; None where the kernel counts none), the
drainers' passes a second (each a wakeup of a drainer in Python, STATS
``fastlane.drainer_passes``), the tenants' CPU summed, and the executes
a second summed.  A window with the broker alone (no lane) comes
first, as the baseline of the broker's own threads; before it, the
drainer's idle wait alone (``idle_wait``: 25 waits of 20 ms on an empty
ring in this process, their ms a wait and the process's cores).

  python -m vtpu_torch.tools.lane_cost                    # on the card
  python -m vtpu_torch.tools.lane_cost --device cpu --seconds 1 \\
      --tenants 1 --spin 200,0 --json out.json

Linux only (``/proc``).  The processes it starts are stopped however it
ends.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

_TICK = os.sysconf("SC_CLK_TCK")
PROGRAM_FLOATS = 256


def proc_cpu_s(pid: int) -> float:
    """User + system seconds of process ``pid``, all its threads."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / _TICK


def proc_switches(pid: int) -> int:
    """Context switches (voluntary and not) of all of ``pid``'s threads."""
    n = 0
    for tid in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{tid}/status") as f:
                for line in f:
                    if line.startswith(("voluntary_ctxt_switches",
                                        "nonvoluntary_ctxt_switches")):
                        n += int(line.split()[1])
        except (FileNotFoundError, ProcessLookupError):
            continue    # a thread that exited between the two reads
    return n


def drainer_passes(sock: str) -> int:
    """The broker's drainer passes so far (a STATS that binds nothing)."""
    import socket

    from ..runtime import protocol as P

    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock)
        P.send_msg(s, {"kind": P.STATS})
        return int(P.recv_msg(s)["fastlane"]["drainer_passes"])


def idle_wait(spin_us: int, tmp: str, n: int = 25) -> Dict[str, float]:
    """``n`` of the drainer's idle waits (20 ms on the tail of a ring
    nothing is sent to): ms a wait, and the cores this process used."""
    from ..shim.core import ExecRing

    ring = ExecRing(os.path.join(tmp, f"idle{spin_us}.ring"), 64)
    try:
        w0, c0 = time.monotonic(), _self_cpu_s()
        for _ in range(n):
            ring.wait_tail(ring.headc + 1, 0.02, spin_us)
        w, c = time.monotonic() - w0, _self_cpu_s() - c0
    finally:
        ring.close()
    return {"ms_per_wait": w / n * 1e3, "cores": c / w}


def _self_cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def tenant_main(sock: str, name: str, go: str) -> Dict:
    """One lane tenant: bind a route, print READY, then the idle and the
    busy window from the start time written into ``go``."""
    import torch

    from ..runtime.client import RuntimeClient

    c = RuntimeClient(sock, tenant=name, fastlane=True)
    if c._lane is None:
        raise SystemExit(f"{name}: no lane negotiated")
    x = torch.ones(PROGRAM_FLOATS)
    c.put(x, "x0")
    exe = c.compile(lambda v: v * 2.0 + 1.0, [x])
    for _ in range(3):      # the first primes over the socket
        c.execute_send_ids(exe.id, ["x0"], ["y0"])
        c.recv_reply()
    print("READY", flush=True)
    while not os.path.exists(go) or not os.path.getsize(go):
        time.sleep(0.005)
    with open(go) as f:
        t0, secs = (float(v) for v in f.read().split())
    time.sleep(max(t0 - time.monotonic(), 0.0))
    cpu0 = _self_cpu_s()
    time.sleep(max(t0 + secs - time.monotonic(), 0.0))
    cpu1 = _self_cpu_s()
    n = 0
    while time.monotonic() < t0 + 2 * secs:
        c.execute_send_ids(exe.id, ["x0"], ["y0"])
        c.recv_reply()
        n += 1
    cpu2 = _self_cpu_s()
    ok = bool(torch.equal(c.get("y0"), x * 2.0 + 1.0))
    ring = (c.stats()[name].get("fastlane") or {}).get("ring_steps", 0)
    c.close()
    return {"idle_cpu_s": cpu1 - cpu0, "busy_cpu_s": cpu2 - cpu1,
            "executes": n, "ring": ring, "ok": ok}


class _Procs:
    """The processes of one run, stopped however it ends."""

    def __init__(self):
        self.procs: List[subprocess.Popen] = []

    def start(self, args, env, **kw) -> subprocess.Popen:
        p = subprocess.Popen([sys.executable, "-m", *args], env=env, **kw)
        self.procs.append(p)
        return p

    def stop(self) -> None:
        for p in reversed(self.procs):
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


def _window(pid: int, sock: str, secs: float,
            t0: float) -> Dict[str, Optional[float]]:
    """The broker's CPU (cores), wakeups and drainer passes a second over
    [t0, t0+secs]."""
    time.sleep(max(t0 - time.monotonic(), 0.0))
    c0, w0, m0 = proc_cpu_s(pid), proc_switches(pid), time.monotonic()
    d0 = drainer_passes(sock)
    time.sleep(max(t0 + secs - time.monotonic(), 0.0))
    c1, w1, m1 = proc_cpu_s(pid), proc_switches(pid), time.monotonic()
    d1 = drainer_passes(sock)
    return {"broker_cores": (c1 - c0) / (m1 - m0),
            "broker_wakeups_per_s": (w1 - w0) / (m1 - m0) if w1 else None,
            "drainer_passes_per_s": (d1 - d0) / (m1 - m0)}


def measure(spin_us: int, tenants: List[int], secs: float, device: str,
            tmp: str) -> Dict:
    """One broker at ``spin_us``: the baseline window, then for each
    count in ``tenants`` that many lane tenants idle and busy."""
    import vtpu_torch

    procs = _Procs()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        vtpu_torch.__file__)))
    env = dict(os.environ, VTPU_FASTLANE="1",
               VTPU_FASTLANE_SPIN_US=str(spin_us),
               PYTHONPATH=os.pathsep.join(
                   [root] + [v for v in [os.environ.get("PYTHONPATH")] if v]))
    sock = os.path.join(tmp, f"lc{spin_us}.sock")
    try:
        broker = procs.start(["vtpu_torch.runtime.server", "--socket", sock,
                              "--device", device, "--region",
                              os.path.join(tmp, f"lc{spin_us}.shr")], env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + 120
        while not os.path.exists(sock + ".admin"):
            if broker.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"the broker did not start "
                                   f"(rc {broker.poll()})")
            time.sleep(0.05)
        out = {"spin_us": spin_us, "idle_wait": idle_wait(spin_us, tmp),
               "alone": _window(broker.pid, sock, secs, time.monotonic())}
        tenv = dict(env, CUDA_VISIBLE_DEVICES="")
        for n in tenants:
            go = os.path.join(tmp, f"lc{spin_us}.{n}.go")
            kids = [procs.start(["vtpu_torch.tools.lane_cost", "--tenant",
                                 sock, f"lc{spin_us}-{n}-{k}", go], tenv,
                                stdout=subprocess.PIPE, text=True)
                    for k in range(n)]
            for p in kids:
                if p.stdout.readline().strip() != "READY":
                    raise RuntimeError(f"a tenant did not start "
                                       f"(rc {p.wait()})")
            t0 = time.monotonic() + 0.2
            with open(go + ".tmp", "w") as f:
                f.write(f"{t0} {secs}")
            os.replace(go + ".tmp", go)
            idle = _window(broker.pid, sock, secs, t0)
            busy = _window(broker.pid, sock, secs, t0 + secs)
            rows = []
            for p in kids:
                line = p.stdout.read().strip().splitlines()
                if p.wait() != 0 or not line:
                    raise RuntimeError(f"a tenant failed (rc {p.returncode})")
                rows.append(json.loads(line[-1]))
            if not all(r["ok"] for r in rows):
                raise RuntimeError("a tenant read wrong values")
            idle["tenants_cores"] = sum(r["idle_cpu_s"] for r in rows) / secs
            busy["tenants_cores"] = sum(r["busy_cpu_s"] for r in rows) / secs
            busy["executes_per_s"] = sum(r["executes"] for r in rows) / secs
            busy["ring_share"] = (sum(r["ring"] for r in rows) /
                                  max(sum(r["executes"] + 3 for r in rows), 1))
            out[f"{n} tenants"] = {"idle": idle, "busy": busy}
        return out
    finally:
        procs.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--spin", default="200,0",
                   help="spins to measure, µs, comma-separated")
    p.add_argument("--tenants", default="2,4",
                   help="tenant counts, comma-separated")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="each window")
    p.add_argument("--json", default=None, help="also write the rows here")
    p.add_argument("--tenant", nargs=3, default=None,
                   metavar=("SOCKET", "NAME", "GO"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.tenant:
        print(json.dumps(tenant_main(*args.tenant)), flush=True)
        return 0
    tenants = [int(v) for v in args.tenants.split(",")]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for spin in (int(v) for v in args.spin.split(",")):
            rows.append(measure(spin, tenants, args.seconds, args.device,
                                tmp))
            print(json.dumps(rows[-1]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
