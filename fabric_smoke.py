#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA probe's fabric levels on one host with
several NVIDIA cards.

Run from the root of a checkout on a host with three or more cards::

    python3 fabric_smoke.py

``chip_smoke.py`` drives every level on one card, where the rank group
spawns no rank and the link sweep has no link to time.  This script drives
what exists only across cards, one line per check (any failure exits
non-zero and prints no result):

1. the mesh-level probe through its entry point (one rank per card, the
   others spawned by the probe child): healthy, schema-valid, every link of
   the rank ring timed;
2. chaos drills through the entry point, each report schema-valid:
   ``TNC_CHAOS_RING_LINK=1`` must name link ``1->2`` alone,
   ``TNC_CHAOS_SLOW_LINK=d:2`` must degrade link ``d/2`` without failing
   the probe, ``TNC_CHAOS_COLLECTIVE_LEG=all_gather`` must fail that leg
   alone;
3. the workload level through its entry point: healthy, the training step
   sharded data × model over every card where the batch of 8 splits (one
   card's flash step on three cards), ``pipeline_ok`` and ``moe_ok`` true;
4. on an even card count, a two-axis label ``TNC_TOPOLOGY=2x{n/2}`` at the
   mesh level (every leg of both axes, named ``t0/h`` and ``t1/h``) and at
   the workload level (healthy over every card), then drills through the
   entry point, each named alone and schema-valid:
   ``TNC_CHAOS_AXIS=t1`` under that label, ``TNC_CHAOS_SLICES=2`` with
   ``TNC_CHAOS_AXIS=dcn`` (named the DCN slice boundary), and
   ``TNC_CHAOS_SLOW_LINK=t1:1``, which degrades the probe without failing
   it;
5. a rank group in this process: the two-axis mesh's sub-groups, created
   and then started by their first collective, each timed; the sharded
   step against the one-card step from the same weights at the full
   ``BurninConfig()``; the pipeline and MoE probes with a stage drill and
   an expert drill; each fabric probe, a dead-link drill, ring attention
   at 1024 tokens a rank, and one more run after rank 0 worked alone past
   the store's wait slice;
6. the emitter across the cards: a workload-level round whose
   ``--probe-timeout`` fires while the child's spawned ranks are up, after
   which no process of its session may remain (a scan of ``/proc``, and
   ``nvidia-smi --query-compute-apps``) and each card's memory use must be
   back to where it stood before; then a healthy workload round; then the
   DaemonSet's ``--watch`` loop at the workload level, sent SIGTERM
   mid-round, which must finish that round's report and exit 143 (the
   seconds from SIGTERM to exit printed);
7. the emitter pod's initContainer across the cards, ``--selftest --json
   --probe-timeout 600`` through the port's CLI (recording each probe
   child's seconds and report, as ``chip_smoke.py`` phase 8 does): exit 0,
   every leg behaved (``baseline``, ``throttle``, ``collective_leg``,
   ``ring_link`` and, on an even count of four or more, ``dcn``), none
   skipped, each leg's seconds printed with the total against the 600 s
   the manifest gives each leg;
8. distributed probing across two stand-in hosts: two emitters
   (``NODE_NAME`` host-a and host-b, each with half the cards through
   ``CUDA_VISIBLE_DEVICES`` and its own ``NCCL_HOSTID``, so NCCL sees two
   hosts) in one ``--probe-distributed`` rendezvous: the enumerate level,
   the CLI's default (healthy on both, the psum ``n/2 × 1 + n/2 × 2``),
   the collective level under each host's label ``--probe-topology
   1x{n/2}``, where each host is one slice (``num_slices`` 2) and the DCN
   fault-domain block runs over dcn × the host's torus (healthy on both,
   the same psum, every axis true, the bus bandwidth of each printed;
   NCCL's transports read from its ``NCCL_DEBUG=INFO`` files, where every
   edge between the halves must use NET and no edge within a half may),
   the same under ``TNC_CHAOS_SLICES=2`` (the rehearsal's override, equal
   layout), ``TNC_CHAOS_AXIS=dcn`` (named on both), ``TNC_CHAOS_RING_LINK`` on the
   link into host-b's first rank (named on both), and the workload level
   (healthy, data × model over every card, equal losses on both); then the
   JAX fleet checker grading both workload reports, and the one-host
   ``TNC_CHAOS_SLICES=2`` figures beside the two-host ones.

``python3 fabric_smoke.py --only emitter`` runs check 6 alone,
``--only selftest`` check 7 and ``--only distributed`` check 8.  The last
line is ``{"ok": true, "cards": n}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import glob
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

# How long the timed-out round runs: past the child's start-up and its
# compute level, so the ranks it spawned are up (about 12 s in), and short
# of the 23-37 s the workload level takes on four cards (PERF.md).
TIMED_OUT_ROUND_S = 20.0


def fail(msg: str) -> None:
    print(f"fabric_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def line(name: str, **fields) -> None:
    print(f"{name}: " + json.dumps(fields, default=str), flush=True)


def smi(query: str) -> list:
    """One ``nvidia-smi`` CSV query, a row of fields per line."""
    out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return [[f.strip() for f in row.split(",")] for row in out.strip().splitlines()]


def descendants(pid: int) -> dict:
    """Every living process under ``pid``: {pid: command line}, from /proc."""
    parent, cmd = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if fields[0] == "Z":
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd[int(entry)] = f.read().replace(b"\0", b" ").decode(errors="replace")[:120]
            parent[int(entry)] = int(fields[1])
        except (OSError, IndexError, ValueError):
            continue  # gone while scanned
    found, frontier = {}, [pid]
    while frontier:
        p = frontier.pop()
        for child, pp in parent.items():
            if pp == p and child not in found:
                found[child] = cmd.get(child, "")
                frontier.append(child)
    return found


def alive(pid: int) -> bool:
    """True while ``pid`` runs (a zombie holds nothing)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def emitter_checks(root: str, n: int) -> None:
    """Check 6: a timed-out round leaves nothing behind, and the loop stops
    on SIGTERM mid-round."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    env["TNC_SCHEMA_STRICT"] = "1"
    work = tempfile.mkdtemp(prefix="fabric-smoke-emitter-")
    used_before = [int(r[0]) for r in smi("--query-gpu=memory.used")]
    apps_before = smi("--query-compute-apps=pid,used_memory")

    # A round killed at its timeout while the ranks it spawned are up.
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
         "--probe-level", "workload", "--probe-timeout", str(TIMED_OUT_ROUND_S)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root, env=env,
    )
    seen, apps_during, ranks_up_s = {}, [], None
    while proc.poll() is None:
        now = descendants(proc.pid)
        seen.update(now)
        if ranks_up_s is None and sum("spawn_main" in c for c in now.values()) >= n - 1:
            ranks_up_s = time.perf_counter() - t0
            apps_during = smi("--query-compute-apps=pid,used_memory")
        time.sleep(0.5)
    out, _ = proc.communicate()
    round_s = time.perf_counter() - t0
    try:
        rep = json.loads(out)
    except json.JSONDecodeError:
        fail(f"the timed-out round printed no report (exit {proc.returncode})")
    left = {p: c for p, c in seen.items() if alive(p)}
    # Card memory comes back once the killed processes are reaped.
    for _ in range(30):
        used_after = [int(r[0]) for r in smi("--query-gpu=memory.used")]
        if all(a <= b + 256 for a, b in zip(used_after, used_before)):
            break
        time.sleep(1.0)
    apps_after = smi("--query-compute-apps=pid,used_memory")
    line("timed-out round", exit_code=proc.returncode, seconds=round_s, error=rep.get("error"),
         ranks_up_s=ranks_up_s, processes_seen=len(seen), processes_left=left,
         compute_apps_before=apps_before, compute_apps_during=apps_during,
         compute_apps_after=apps_after, memory_used_mib_before=used_before,
         memory_used_mib_after=used_after)
    if proc.returncode != 3 or not (rep.get("error") or "").startswith(
            f"probe timed out after {TIMED_OUT_ROUND_S}s"):
        fail(f"the round did not time out: exit {proc.returncode}, {rep.get('error')}")
    if ranks_up_s is None:
        fail(f"the ranks were not up before the timeout: {seen}")
    if left or apps_after != apps_before:
        fail(f"processes of the timed-out round remain: {left} {apps_after}")
    if any(a > b + 256 for a, b in zip(used_after, used_before)):
        fail(f"card memory not freed: {used_before} MiB before, {used_after} MiB after")

    # The next round, healthy on every card.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
         "--probe-level", "workload"],
        capture_output=True, text=True, cwd=root, timeout=600, env=env,
    )
    rep = json.loads(proc.stdout) if proc.stdout.strip() else {}
    line("round after the timed-out one", exit_code=proc.returncode,
         seconds=time.perf_counter() - t0, ok=rep.get("ok"), error=rep.get("error"),
         workload_devices=rep.get("workload_devices"))
    if proc.returncode != 0 or not rep.get("ok"):
        fail(f"the round after the timed-out one is not healthy: {rep.get('error')}")

    # The DaemonSet's loop at the workload level, SIGTERM in mid-round: the
    # round finishes, writes its report and line, and the loop exits 143.
    report, log = os.path.join(work, "node.json"), os.path.join(work, "rounds.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", report,
         "--probe-level", "workload", "--watch", "600", "--log-jsonl", log],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, cwd=root, env=env,
    )
    time.sleep(TIMED_OUT_ROUND_S)
    t_term = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    term_s = time.perf_counter() - t_term
    err = proc.stderr.read()
    proc.stderr.close()
    with open(log) as f:
        entries = [json.loads(x) for x in f.read().splitlines()]
    with open(report) as f:
        rep = json.load(f)
    line("--watch at the workload level, SIGTERM mid-round", exit_code=rc,
         sigterm_after_s=t_term - t0, sigterm_to_exit_s=term_s, round_elapsed_ms=rep.get(
             "elapsed_ms"), ok=rep.get("ok"), log=entries, stderr_tail=err.strip().splitlines())
    if rc != 143 or len(entries) != 1 or entries[0]["exit_code"] != 0 or not rep.get("ok"):
        fail(f"the loop did not finish its round and stop: exit {rc}, {entries}")


def selftest_check(root: str, n: int) -> None:
    """Check 7: the initContainer's drill on every card."""
    from chip_smoke import observed_cli

    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    work = tempfile.mkdtemp(prefix="fabric-smoke-selftest-")
    proc, legs, seconds = observed_cli(root, work, "selftest", "--selftest", "--json",
                                       "--probe-timeout", "600", env=env)
    try:
        doc = json.loads(proc.stdout)
    except json.JSONDecodeError:
        fail(f"--selftest printed no document (exit {proc.returncode}): {proc.stderr[-2000:]}")
    results = doc.get("selftest", [])
    line("initContainer --selftest --json --probe-timeout 600", exit_code=proc.returncode,
         seconds=seconds, behaved={x["leg"]: x["behaved"] for x in results},
         details={x["leg"]: x["detail"] for x in results}, skipped_legs=doc.get("skipped_legs"),
         leg_seconds={x["leg"]: leg["seconds"] for x, leg in zip(results, legs)},
         leg_levels=[leg["args"].get("level") for leg in legs],
         leg_env=[leg["env"] for leg in legs],
         slowest_leg_over_600_s=max(leg["seconds"] for leg in legs) / 600 if legs else None,
         total_over_600_s_a_leg=seconds / (600 * max(len(legs), 1)))
    want = ["baseline", "throttle", "collective_leg", "ring_link"]
    if n >= 4 and n % 2 == 0:
        want.append("dcn")
    if (proc.returncode != 0 or [x["leg"] for x in results] != want
            or not all(x["behaved"] for x in results) or doc.get("skipped_legs")):
        fail(f"the selftest on {n} cards: exit {proc.returncode}, {results}, "
             f"skipped {doc.get('skipped_legs')}")


def distributed_check(root: str, n: int) -> None:
    """Check 8: two emitters, each with half the cards, stand in for two
    hosts of one distributed probe."""
    from chip_smoke import aggregate, free_port
    from tpu_node_checker_torch.probe.schema import validate_report

    if n < 4 or n % 2:
        fail(f"the distributed check splits the cards into two hosts: needs an even count "
             f"of four or more, {n} visible")
    half = n // 2
    hosts = ("host-a", "host-b")
    base = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    base["TNC_SCHEMA_STRICT"] = "1"
    work = tempfile.mkdtemp(prefix="fabric-smoke-distributed-")
    nccl_logs = os.path.join(work, "nccl")
    os.mkdir(nccl_logs)
    keys = ("ok", "error", "elapsed_ms", "rendezvous_ms", "device_count", "local_device_count",
            "process_index", "process_count", "distributed_psum", "distributed_psum_ok",
            "collective_ok", "collective_busbw_gbps", "ring_ok", "ring_link_gbps",
            "ring_bad_links", "ici_axis_ok", "ici_axis_busbw_gbps", "fault_domain_ok",
            "fault_domain_busbw_gbps", "dcn_busbw_gbps", "workload_ok", "workload_devices",
            "workload_losses", "workload_step_ms", "ring_attention_ok", "pipeline_ok",
            "moe_ok", "kernel_launches", "chaos_injected")

    def emitter(i: int, coord: str, level: str, args: tuple, extra: dict, debug: bool):
        cards = ",".join(str(c) for c in range(i * half, (i + 1) * half))
        env = {**base, "NODE_NAME": hosts[i], "CUDA_VISIBLE_DEVICES": cards,
               "NCCL_HOSTID": hosts[i], **extra}
        if debug:
            env.update(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT,P2P,NET",
                       NCCL_DEBUG_FILE=os.path.join(nccl_logs, f"{hosts[i]}.%p.log"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
             "--probe-level", level, "--probe-distributed", "--probe-coordinator", coord,
             "--probe-num-processes", "2", "--probe-process-id", str(i),
             "--probe-rendezvous-timeout", "60", *args],
            capture_output=True, text=True, cwd=root, timeout=900, env=env,
        )
        seconds = time.perf_counter() - t0
        try:
            rep = json.loads(proc.stdout)
        except json.JSONDecodeError:
            fail(f"{hosts[i]} at {level} {extra} printed no report (exit {proc.returncode}): "
                 f"{proc.stderr[-2000:]}")
        violations = validate_report(rep)
        if violations:
            fail(f"{hosts[i]} at {level} {extra}: the report violates the schema: {violations}")
        return proc.returncode, rep, seconds

    def distributed_round(name: str, level: str, *args, extra=None, debug=False) -> list:
        coord = f"127.0.0.1:{free_port()}"
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            runs = list(pool.map(lambda i: emitter(i, coord, level, args, extra or {}, debug),
                                 range(2)))
        line(f"distributed {name}", **{hosts[i]: {"exit_code": rc, "seconds": sec,
                                                  **{k: rep.get(k) for k in keys if k in rep}}
                                       for i, (rc, rep, sec) in enumerate(runs)})
        return runs

    def healthy(runs: list, what: str) -> None:
        for host, (rc, rep, _) in zip(hosts, runs):
            if (rc != 0 or rep.get("ok") is not True or rep.get("distributed") is not True
                    or rep.get("device_count") != n or rep.get("local_device_count") != half
                    or rep.get("process_count") != 2
                    or rep.get("distributed_psum") != float(half * 1 + half * 2)
                    or rep.get("distributed_psum_ok") is not True):
                fail(f"{what} on {host}: exit {rc}, {rep.get('error')}, "
                     f"psum {rep.get('distributed_psum')}")

    # The CLI's default level: the meeting and the psum over one rank per
    # process, with no rank spawned.
    runs = distributed_round("enumerate (the default level)", "enumerate")
    healthy(runs, "the enumerate level")

    # Each host is one slice: its label describes its own cards, and the
    # fault-domain block runs over dcn (the host boundary) x its torus.
    topo = f"1x{half}"
    runs = distributed_round(f"collective --probe-topology {topo}, each host a slice",
                             "collective", "--probe-topology", topo, debug=True)
    healthy(runs, "the collective level")
    for host, (_, rep, _) in zip(hosts, runs):
        if (rep.get("num_slices") != 2 or rep.get("slice_indices") != [0, 1]
                or rep.get("fault_domain_ok") != {"dcn": True, "t0": True, "t1": True}
                or not (rep.get("dcn_busbw_gbps") or 0) > 0):
            fail(f"the dcn block on {host}: slices {rep.get('num_slices')}, "
                 f"{rep.get('fault_domain_ok')}, {rep.get('dcn_busbw_gbps')} GB/s")
    # NCCL's transport on each edge, from its INIT/P2P/NET lines
    # ("Channel 00/0 : 1[1] -> 2[2] [send] via NET/Socket/0").  The rank is
    # the communicator's, so an edge is placed by the bracketed id, the
    # card's NVML index: the numbering of the CUDA_VISIBLE_DEVICES given to
    # each host above.  If NCCL took the two NCCL_HOSTIDs for two hosts,
    # every edge between the halves uses NET and no edge within a half does.
    owner = {str(c): hosts[c // half] for c in range(n)}
    transports = {}
    for path in sorted(glob.glob(os.path.join(nccl_logs, "*.log"))):
        host = os.path.basename(path).split(".")[0]
        with open(path, errors="replace") as f:
            for text in f:
                via = re.search(r"\d+\[(\w+)\] -> \d+\[(\w+)\] (?:\[\w+\] )?via (\S+)",
                                text)
                if not via:
                    continue
                src, dst, how = via.groups()
                where = ("unplaced" if src not in owner or dst not in owner else
                         "within the halves" if owner[src] == owner[dst] else
                         "between the halves")
                transports.setdefault(where, {}).setdefault(how, set()).add(
                    f"{host}:{src}->{dst}")
    net = {where: sorted({how.startswith("NET") for how in hows})
           for where, hows in transports.items()}
    hostid_split_ok = net.get("between the halves") == [True] and net.get(
        "within the halves") == [False] and "unplaced" not in net
    line("NCCL transports between devices (NCCL_DEBUG=INFO, the collective round)",
         files=len(glob.glob(os.path.join(nccl_logs, "*.log"))),
         transports={w: {v: sorted(e) for v, e in vias.items()}
                     for w, vias in transports.items()},
         hostid_split_ok=hostid_split_ok)

    runs = distributed_round("TNC_CHAOS_SLICES=2, dcn on the process boundary", "collective",
                             "--probe-topology", f"1x{half}", extra={"TNC_CHAOS_SLICES": "2"})
    healthy(runs, "the multislice block")
    two_host_bw = runs[0][1].get("fault_domain_busbw_gbps")
    for host, (_, rep, _) in zip(hosts, runs):
        if (rep.get("fault_domain_ok") != {"dcn": True, "t0": True, "t1": True}
                or not (rep.get("dcn_busbw_gbps") or 0) > 0):
            fail(f"the dcn axis on {host}: {rep.get('fault_domain_ok')}, "
                 f"{rep.get('dcn_busbw_gbps')} GB/s")

    runs = distributed_round("TNC_CHAOS_AXIS=dcn drill", "collective", "--probe-topology",
                             f"1x{half}", extra={"TNC_CHAOS_AXIS": "dcn"})
    for host, (rc, rep, _) in zip(hosts, runs):
        if (rc != 3 or "DCN slice boundary" not in (rep.get("error") or "")
                or rep.get("fault_domain_ok") != {"dcn": False, "t0": True, "t1": True}):
            fail(f"the dcn drill on {host}: exit {rc}, {rep.get('error')}, "
                 f"{rep.get('fault_domain_ok')}")

    link = f"{half - 1}->{half}"
    runs = distributed_round(f"TNC_CHAOS_RING_LINK={half - 1} drill ({link}, into host-b)",
                             "collective", extra={"TNC_CHAOS_RING_LINK": str(half - 1)})
    for host, (rc, rep, _) in zip(hosts, runs):
        if rc != 3 or rep.get("ring_bad_links") != [link]:
            fail(f"the ring drill on {host}: exit {rc}, {rep.get('ring_bad_links')}")

    runs = distributed_round("workload", "workload")
    healthy(runs, "the workload level")
    for host, (_, rep, _) in zip(hosts, runs):
        bad = [k for k in ("workload_ok", "ring_attention_ok", "pipeline_ok", "moe_ok")
               if rep.get(k) is not True]
        if bad or rep.get("workload_devices") != n:
            fail(f"the workload level on {host}: {bad}, {rep.get('workload_devices')} devices")
    if runs[0][1].get("workload_losses") != runs[1][1].get("workload_losses"):
        fail(f"the hosts' losses differ: {[rep.get('workload_losses') for _, rep, _ in runs]}")

    # The fleet checker over both hosts' reports, as the aggregator reads them.
    reports = os.path.join(work, "reports")
    os.mkdir(reports)
    for host, (_, rep, _) in zip(hosts, runs):
        with open(os.path.join(reports, f"{host}.json"), "w") as f:
            json.dump(rep, f)
    resources = {"cpu": "8", "memory": "32Gi", "pods": "110", "nvidia.com/gpu": str(half)}
    nodes = os.path.join(work, "nodes.json")
    with open(nodes, "w") as f:
        json.dump({"kind": "NodeList", "apiVersion": "v1", "items": [{
            "metadata": {"name": host, "labels": {}}, "spec": {},
            "status": {"allocatable": resources, "capacity": dict(resources),
                       "conditions": [{"type": "Ready", "status": "True"}]},
        } for host in hosts]}, f)
    rc, payload = aggregate(root, nodes, reports, base)
    summary = payload.get("probe_summary") or {}
    line("the JAX fleet checker over both workload reports", exit_code=rc, probe_summary=summary)
    if rc != 0 or summary.get("hosts_ok") != 2 or summary.get("hosts_failed"):
        fail(f"the fleet checker did not grade both hosts ok: exit {rc}, {summary}")

    # The same multislice block on one host with every card, for its figures.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
         "--probe-level", "collective", "--probe-topology", f"1x{half}"],
        capture_output=True, text=True, cwd=root, timeout=600,
        env={**base, "TNC_CHAOS_SLICES": "2"},
    )
    one = json.loads(proc.stdout) if proc.stdout.strip() else {}
    line("one host, TNC_CHAOS_SLICES=2, beside the two stand-in hosts", exit_code=proc.returncode,
         seconds=time.perf_counter() - t0, one_host_fault_domain_busbw_gbps=one.get(
             "fault_domain_busbw_gbps"), two_host_fault_domain_busbw_gbps=two_host_bw,
         one_host_ring_link_gbps=one.get("ring_link_gbps"))
    if proc.returncode != 0 or one.get("ok") is not True:
        fail(f"the one-host multislice round: exit {proc.returncode}, {one.get('error')}")
    # Checked last, so the rounds above report even when NCCL joined the
    # stand-in hosts over P2P.
    if not hostid_split_ok:
        fail(f"NCCL did not take the halves for two hosts (NCCL_HOSTID): {transports}")


def main() -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--only", choices=["emitter", "selftest", "distributed"],
                      help="run only check 6 (emitter), 7 (selftest) or 8 (distributed)")
    only = args.parse_args().only
    try:
        import torch
    except ImportError as exc:
        fail(f"torch does not import: {exc}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 3:
        fail(f"needs three or more NVIDIA cards, {n} visible")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from tpu_node_checker_torch.convert import burnin_shard
        from tpu_node_checker_torch.meshprobe import mesh_link_sweep
        from tpu_node_checker_torch.meshprobe.sweep import link_names
        from tpu_node_checker_torch.models.burnin import (
            Burnin, BurninConfig, train_steps, workload_mesh, workload_probe,
        )
        from tpu_node_checker_torch.parallel import (
            MeshSpec, RankFailure, RankGroup, build_mesh, collective_probe, fold, moe_probe,
            per_axis_probe, pipeline_probe, ring_attention_probe, ring_probe,
        )
        from tpu_node_checker_torch.probe.schema import validate_report
    except ImportError as exc:
        fail(f"the tpu_node_checker_torch package is not beside this script: {exc}")
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    line("environment", torch=torch.__version__, cards=cards)
    if only:
        {"emitter": emitter_checks, "selftest": selftest_check,
         "distributed": distributed_check}[only](root, n)
        print(json.dumps({"ok": True, "cards": n}), flush=True)
        return 0

    def probe(level: str, **env) -> tuple:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
             "--probe-level", level],
            capture_output=True, text=True, cwd=root, timeout=600,
            env={**os.environ, **env, "TNC_SCHEMA_STRICT": "1"},
        )
        seconds = time.perf_counter() - t0
        try:
            report = json.loads(proc.stdout)
        except json.JSONDecodeError:
            fail(f"{level} {env} printed no report (exit {proc.returncode}): {proc.stderr[-2000:]}")
        violations = validate_report(report)
        if violations:
            fail(f"{level} {env} report violates the schema: {violations}")
        return proc.returncode, report, seconds

    keys = ("ok", "error", "device_count", "elapsed_ms", "collective_ok",
            "collective_latency_us", "collective_busbw_gbps", "collective_legs_ok",
            "ring_ok", "ring_link_gbps", "ring_bad_links", "mesh_ok", "mesh_degraded",
            "mesh_n_links", "mesh_slow_links", "mesh_dead_links", "chaos_injected")

    # -- 1. the mesh level, healthy
    rc, rep, seconds = probe("mesh")
    line("mesh level", exit_code=rc, seconds=seconds, **{k: rep.get(k) for k in keys})
    if rc != 0 or not rep.get("ok") or rep.get("device_count") != n:
        fail(f"mesh-level probe not healthy on {n} cards: {rep.get('error')}")
    if rep.get("mesh_n_links") != n or rep.get("mesh_dead_links"):
        fail(f"link sweep: {rep.get('mesh_n_links')} links, dead {rep.get('mesh_dead_links')}")

    # -- 2. chaos drills, each named exactly
    drills = (
        ("mesh", {"TNC_CHAOS_RING_LINK": "1"}, 3,
         lambda r: r.get("ring_bad_links") == ["1->2"]),
        ("mesh", {"TNC_CHAOS_SLOW_LINK": "d:2"}, 0,
         lambda r: r.get("mesh_degraded") is True and "d/2" in r.get("mesh_slow_links", [])
         and not r.get("mesh_dead_links")),
        ("collective", {"TNC_CHAOS_COLLECTIVE_LEG": "all_gather"}, 3,
         lambda r: [r["collective_legs_ok"][f"{leg}_ok"] for leg in
                    ("psum", "all_gather", "reduce_scatter")] == [True, False, True]),
    )
    for level, env, want_rc, named in drills:
        rc, rep, seconds = probe(level, **env)
        line(f"drill {env}", exit_code=rc, seconds=seconds, **{k: rep.get(k) for k in keys})
        if rc != want_rc or not named(rep):
            fail(f"drill {env} not caught and named as expected")

    # -- 3. the workload level on every card: the step sharded data x model
    # where the batch splits (one card's flash step on three), pipeline, MoE
    rc, rep, seconds = probe("workload")
    want_devices = n if workload_mesh(n, BurninConfig().batch) is not None else 1
    line("workload level", exit_code=rc, seconds=seconds, **{k: rep.get(k) for k in (
        "ok", "error", "elapsed_ms", "workload_ok", "workload_devices", "workload_losses",
        "workload_step_ms", "ring_attention_ok", "pipeline_ok", "moe_ok", "kernel_launches")})
    if rc != 0 or not rep.get("ok") or rep.get("workload_devices") != want_devices:
        fail(f"workload level not healthy on {n} cards over {want_devices}: {rep.get('error')}")
    if not (rep.get("pipeline_ok") is True and rep.get("moe_ok") is True):
        fail(f"pipeline_ok {rep.get('pipeline_ok')}, moe_ok {rep.get('moe_ok')}")

    # -- 4. a two-axis topology label: every leg of both axes, then the
    # per-axis, multislice and slow-link drills, each named alone
    if n % 2 == 0:
        topo = f"2x{n // 2}"
        axis_keys = ("ok", "error", "ici_axis_ok", "ici_topology", "ici_axis_busbw_gbps",
                     "fault_domain_ok", "fault_domain_topology", "fault_domain_busbw_gbps",
                     "dcn_busbw_gbps", "mesh_n_links", "mesh_slow_links", "mesh_dead_links",
                     "mesh_degraded", "chaos_injected")
        rc, rep, seconds = probe("mesh", TNC_TOPOLOGY=topo)
        links = list(((rep.get("collective_legs_ok") or {}).get("links") or {}))
        line(f"mesh level, TNC_TOPOLOGY={topo}", exit_code=rc, seconds=seconds, links=links,
             **{k: rep.get(k) for k in axis_keys})
        if rc != 0 or not rep.get("ok") or links != link_names(topo, n):
            fail(f"{topo} mesh level: links {links}, error {rep.get('error')}")
        if rep.get("ici_axis_ok") != {"t0": True, "t1": True}:
            fail(f"{topo} per-axis verdicts {rep.get('ici_axis_ok')}")
        # The workload level under the label: the data x model step's lines
        # are the label's (2x2 on four cards), so it reuses their groups.
        rc, rep, seconds = probe("workload", TNC_TOPOLOGY=topo)
        line(f"workload level, TNC_TOPOLOGY={topo}", exit_code=rc, seconds=seconds,
             **{k: rep.get(k) for k in ("ok", "error", "elapsed_ms", "ici_axis_ok",
                                        "workload_devices", "workload_losses",
                                        "workload_step_ms", "pipeline_ok", "moe_ok")})
        if (rc != 0 or not rep.get("ok") or rep.get("workload_devices") != n
                or rep.get("ici_axis_ok") != {"t0": True, "t1": True}):
            fail(f"{topo} workload level not healthy: {rep.get('error')}")
        drills = (
            ("collective", {"TNC_TOPOLOGY": topo, "TNC_CHAOS_AXIS": "t1"}, 3,
             lambda r: r.get("ici_axis_ok") == {"t0": True, "t1": False}
             and f"fault localized to mesh axis t1={n // 2}" in (r.get("error") or "")),
            ("collective", {"TNC_CHAOS_SLICES": "2", "TNC_CHAOS_AXIS": "dcn"}, 3,
             lambda r: r.get("fault_domain_ok") == {"dcn": False, "d": True}
             and "fault localized to the DCN slice boundary" in (r.get("error") or "")
             and r.get("dcn_busbw_gbps") is not None),
            ("mesh", {"TNC_TOPOLOGY": topo, "TNC_CHAOS_SLOW_LINK": "t1:1"}, 0,
             lambda r: r.get("ok") is True and r.get("mesh_degraded") is True
             and "t1/1" in (r.get("mesh_slow_links") or []) and not r.get("mesh_dead_links")),
        )
        for level, env, want_rc, named in drills:
            rc, rep, seconds = probe(level, **env)
            line(f"drill {env}", exit_code=rc, seconds=seconds,
                 **{k: rep.get(k) for k in axis_keys})
            if rc != want_rc or not named(rep):
                fail(f"drill {env} not caught and named as expected")

    # -- 5. a rank group in this process
    results = {}
    t0 = time.perf_counter()
    with RankGroup(n, "cuda", timeout_s=120) as group:
        line("rank group", ranks=n, spawned_ranks=n - 1, start_s=time.perf_counter() - t0)
        # The sub-groups of a two-axis mesh: created (every rank, every line),
        # then their communicators' start at the first collective over them.
        if n % 2 == 0:
            spec = MeshSpec((("t0", 2), ("t1", n // 2)))
            t1 = time.perf_counter()
            built = group.run(build_mesh, spec)
            created_s = time.perf_counter() - t1
            firsts = []
            for _ in range(2):
                t1 = time.perf_counter()
                axes = fold(group.run(per_axis_probe, mesh=spec))
                firsts.append(time.perf_counter() - t1)
            line("sub-groups", mesh=spec.axes, create_s=created_s, first_per_axis_s=firsts[0],
                 second_per_axis_s=firsts[1], axis_ok=(axes.details or {}).get("axis_ok"),
                 lines=[m.lines for m in built if not isinstance(m, RankFailure)])
            if not axes.ok or any(isinstance(m, RankFailure) for m in built):
                fail(f"the {spec.axes} sub-groups did not form: {axes.error} {built}")
        # The sharded step against the one-card step from the same weights
        # and tokens, at the full BurninConfig(), then the workload level's
        # other blocks and their drills.
        cfg = BurninConfig()
        wspec = workload_mesh(n, cfg.batch)
        if wspec is not None:
            state = {k: t.detach().clone() for k, t in
                     Burnin(cfg, torch.Generator().manual_seed(0)).state_dict().items()}
            tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                                   generator=torch.Generator().manual_seed(1))
            one = train_steps(cfg, None, 2, state=state, tokens=tokens, keep_grads=True)
            t1 = time.perf_counter()
            runs = group.run(train_steps, cfg, wspec, 2, state=state, tokens=tokens,
                             keep_grads=True)
            sharded_s = time.perf_counter() - t1
            if any(isinstance(r, RankFailure) for r in runs):
                fail(f"the sharded step failed: {runs}")
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs[0][0], one[0]))
            grad_rel = 0.0
            for rank, (_, _, grads) in enumerate(runs):
                coords = tuple(int(c) for c in divmod(rank, wspec.shape[1]))
                want = burnin_shard(one[2], cfg, wspec, coords)
                grad_rel = max([grad_rel] + [
                    float((g - want[k]).norm() / want[k].norm()) for k, g in grads.items()])
            line("sharded step against one card", mesh=wspec.axes, seconds=sharded_s,
                 sharded_losses=runs[0][0], one_card_losses=one[0],
                 sharded_step_ms=runs[0][1], one_card_step_ms=one[1],
                 loss_rel=loss_rel, worst_grad_rel_l2=grad_rel)
            if loss_rel >= 1e-3 or grad_rel >= 5e-2:
                fail(f"the sharded step disagrees with one card: {loss_rel}, {grad_rel}")
        for name, fn, kw, named in (
            ("pipeline", pipeline_probe, {}, None),
            ("pipeline stage drill", pipeline_probe, {"inject_fault_stage": n - 2},
             lambda r: r.details["first_bad_stage"] == n - 2),
            ("moe", moe_probe, {}, None),
            ("moe expert drill", moe_probe, {"inject_fault_expert": 1},
             lambda r: r.details["bad_experts"] == [1]),
        ):
            t1 = time.perf_counter()
            r = fold(group.run(fn, **kw))
            line(name, seconds=time.perf_counter() - t1, result=dataclasses.asdict(r))
            if r.ok != (named is None) or (named is not None and not named(r)):
                fail(f"{name}: ok={r.ok}: {r.error}")
        for name, fn, kw, want_ok in (
            ("collective", collective_probe, {}, True),
            ("ring", ring_probe, {}, True),
            ("ring swap drill", ring_probe, {"inject_fault_link": 2, "inject_fault_swap": True},
             False),
            ("sweep dead-link drill", mesh_link_sweep, {"inject_dead_link": "d:1"}, False),
            ("ring attention", ring_attention_probe, {"seq_per_device": 16}, True),
            ("ring attention, 1024 tokens a rank", ring_attention_probe,
             {"seq_per_device": 1024, "head_dim": 64}, True),
        ):
            t1 = time.perf_counter()
            r = fold(group.run(fn, **kw))
            results[name] = r
            line(name, seconds=time.perf_counter() - t1, result=dataclasses.asdict(r))
            if r.ok != want_ok:
                fail(f"{name}: ok={r.ok}, expected {want_ok}: {r.error}")
        if results["ring swap drill"].details.get("bad_links") != ["2->3"]:
            fail("the ring swap drill was not named 2->3")
        if results["sweep dead-link drill"].dead != ["d/1"]:
            fail("the sweep's dead-link drill was not named d/1")
        # Rank 0 alone past the store's wait slice, then the group again.
        t1 = time.perf_counter()
        wl = workload_probe(dataclasses.replace(BurninConfig(), attention="flash"))
        time.sleep(max(0.0, 3.0 - (time.perf_counter() - t1)))
        again = fold(group.run(ring_attention_probe, seq_per_device=16))
        line("after rank 0 worked alone", alone_s=time.perf_counter() - t1,
             workload_ok=wl.ok, ring_attention_ok=again.ok)
        if not (wl.ok and again.ok):
            fail("the group did not survive rank 0 working alone")

    # -- 6. the emitter across the cards
    emitter_checks(root, n)
    # -- 7. the initContainer's drill across the cards
    selftest_check(root, n)
    # -- 8. one distributed probe over two stand-in hosts, each half the cards
    if n % 2 == 0:
        distributed_check(root, n)
    else:
        line("distributed check skipped", reason=f"{n} cards do not split into two hosts")
    print(json.dumps({"ok": True, "cards": n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
