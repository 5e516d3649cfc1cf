"""The port's hub serving front end (`repro_torch.hub.serving`: protocol,
`HubServer`, `HubClient`) against the reference, on the CPU.

  * The reference's own cases (`tests/test_serving.py`: `TestProtocol`,
    `TestHubServer`, `TestStatsColumns`) run on the port, `_tune_batch`
    faked as the reference fakes it; the hammer's spawn target is the
    port's own load generator (`launch.hub._serve_client_main`).
  * Across packages: `send_frame` writes identical bytes and each
    `recv_frame` reads the other's; each package's client is served by the
    other's server; an unfaked tune-on-miss under `tenset-pretrain`, with
    params from one `.npz`, serves the same winner through both servers.
  * Reader and client processes load no torch.

Every socket, join and queue wait has its own timeout.
"""
import json
import multiprocessing as mp
import os
import shutil
import socket
import sys
import threading
import time
import types

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.autotune.registry import Registry as JRegistry  # noqa: E402
from repro.autotune.space import ProgramConfig as JPC  # noqa: E402
from repro.autotune.space import Workload as JWorkload  # noqa: E402
from repro.hub.serving import protocol as j_protocol  # noqa: E402
from repro.hub.store import RecordStore as JStore  # noqa: E402
from repro_torch.autotune.registry import Registry  # noqa: E402
from repro_torch.autotune.space import (ProgramConfig, Workload,  # noqa: E402
                                        default_config)
from repro_torch.hub.serving import protocol  # noqa: E402
from repro_torch.hub.serving.client import HubClient  # noqa: E402
from repro_torch.hub.serving.server import HubServer, endpoints_path  # noqa: E402,E501
from repro_torch.hub.service import TuningHub  # noqa: E402
from repro_torch.hub.store import RecordStore  # noqa: E402
from repro_torch.launch import hub as launch_hub  # noqa: E402

WL_A = Workload("matmul", (256, 256, 128), name="a")
WL_B = Workload("matmul", (512, 256, 128), name="b")
WL_C = Workload("matmul", (128, 256, 128), name="c")    # store-only task
CFG_A = default_config(WL_A)
CFG_B = ProgramConfig.make(block_m=64, block_n=128, block_k=128,
                           k_inner=0, unroll=1, out_bf16=1)
DET_CFG = ProgramConfig.make(block_m=64, block_n=64, block_k=128,
                             k_inner=1, unroll=1, out_bf16=1)
J_WL_A = JWorkload("matmul", (256, 256, 128), name="a")
J_WL_C = JWorkload("matmul", (128, 256, 128), name="c")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    machine's cores (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps_torch(pid: int) -> bool:
    """Whether process `pid` has a torch library mapped."""
    return "libtorch" in open(f"/proc/{pid}/maps").read()


# --- the reference's cases, on the port ------------------------------------


class TestProtocol:
    def test_round_trip(self):
        a, b = socket.socketpair()
        with a, b:
            b.settimeout(10)
            protocol.send_frame(a, {"op": "ping", "x": [1, 2, 3]})
            assert protocol.recv_frame(b) == {"op": "ping", "x": [1, 2, 3]}

    def test_clean_eof_is_none_torn_is_error(self):
        a, b = socket.socketpair()
        a.close()
        with b:
            b.settimeout(10)
            assert protocol.recv_frame(b) is None
        a, b = socket.socketpair()
        with b:
            b.settimeout(10)
            a.sendall(b"\x00\x00")                  # half a length prefix
            a.close()
            with pytest.raises(protocol.ProtocolError):
                protocol.recv_frame(b)

    def test_oversized_frame_rejected(self):
        a, b = socket.socketpair()
        with a, b:
            b.settimeout(10)
            a.sendall((protocol.MAX_FRAME + 1).to_bytes(4, "big"))
            with pytest.raises(protocol.ProtocolError):
                protocol.recv_frame(b)

    def test_workload_config_wire_round_trip(self):
        wl = protocol.workload_from_wire(protocol.workload_to_wire(WL_A))
        assert wl == WL_A and wl.key() == WL_A.key()
        cfg = protocol.config_from_wire(protocol.config_to_wire(CFG_B))
        assert cfg.knobs == CFG_B.knobs


def _fake_tune(hub, calls):
    def fake(dev, tasks):
        calls.append(sorted(wl.key() for wl in tasks))
        time.sleep(0.2)                     # widen the client race window
        for wl in tasks:
            hub.registry.put(dev, wl, DET_CFG, 321.0)
        hub.registry.save()
        with hub._stats_lock:
            hub.stats.jobs += 1
        return types.SimpleNamespace(total_measurements=len(tasks),
                                     tasks=[])
    return fake


def _spawn(target, arg_tuples):
    """One spawn process per tuple; `Q` in a tuple stands for the shared
    result queue."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=target, daemon=True,
                         args=tuple(out_q if a is Q else a for a in args))
             for args in arg_tuples]
    for p in procs:
        p.start()
    return procs, out_q


Q = object()


def _collect(procs, out_q, timeout=120):
    reports = [out_q.get(timeout=timeout) for _ in procs]
    for p in procs:
        p.join(10)
    return reports


class TestHubServer:
    def test_end_to_end_and_concurrent_hammer(self, tmp_path):
        """One server boot, three acts: (1) serving-source semantics for a
        single client; (2) N threads racing tune-on-miss for one untuned
        workload — exactly ONE tuning job runs and every thread gets the
        deterministic winner; (3) a multi-process client hammer with zero
        torn replies."""
        root = str(tmp_path / "hub")
        hub = TuningHub(root, torch_device="cpu")
        hub.registry.put("tpu_v5e", WL_A, CFG_A, 100.0)
        hub.store.put("tpu_v5e", WL_C, CFG_B, 50.0)
        hub.store.flush()
        calls = []
        hub._tune_batch = _fake_tune(hub, calls)

        with HubServer(root, hub=hub, readers=2) as srv:
            with HubClient(root=root) as c:
                assert c.ping()
                r = c.get_config("tpu_v5e", WL_A, tune=False)
                assert r.source == "registry"
                assert r.config.knobs == CFG_A.knobs
                assert c.get_config("tpu_v5e", WL_A,
                                    tune=False).source == "cache"
                r = c.get_config("tpu_v5e", WL_C, tune=False)
                assert r.source == "store"
                assert r.config.knobs == CFG_B.knobs

            # act 2: concurrent tune-on-miss funnel, one job, one winner
            results, errs = [], []

            def _query(i):
                try:
                    with HubClient(root=root, offset=i,
                                   tune_timeout_s=60.0) as cl:
                        results.append(
                            cl.get_config("tpu_v5e", WL_B, tune=True))
                except Exception as e:  # noqa: BLE001
                    errs.append(repr(e))

            threads = [threading.Thread(target=_query, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not errs, errs
            assert len(results) == 6
            for r in results:
                assert r.config.knobs == DET_CFG.knobs, (
                    f"client saw a non-deterministic winner via {r.source}")
            assert len(calls) == 1, (
                f"in-flight dedup failed: {len(calls)} tuning jobs ran")

            # act 3: multi-process hammer over hit + store-miss paths,
            # through the port's own load generator
            pairs = [["tpu_v5e", protocol.workload_to_wire(WL_A)],
                     ["tpu_v5e", protocol.workload_to_wire(WL_C)]]
            expect = {f"tpu_v5e|{WL_A.key()}": dict(CFG_A.knobs),
                      f"tpu_v5e|{WL_C.key()}": dict(CFG_B.knobs)}
            procs, out_q = _spawn(launch_hub._serve_client_main,
                                  [(root, cid, 1.5, Q, pairs, expect)
                                   for cid in range(4)])
            reports = _collect(procs, out_q)
            total = sum(r["requests"] for r in reports)
            assert sum(r["errors"] for r in reports) == 0
            assert sum(r["wrong"] for r in reports) == 0
            assert total > 50, f"hammer barely ran: {total} requests"

            agg = srv.stats()
            assert agg["writer"]["jobs"] == 1
            assert sum(r.get("served", 0) for r in agg["readers"]) >= total

    def test_reader_kill_respawn_and_failover(self, tmp_path):
        """The farm liveness contract: a SIGKILLed reader is detected by
        the missed-heartbeat watchdog, respawned on a fresh port, and the
        endpoints file is republished so clients keep being served."""
        root = str(tmp_path / "hub")
        store = RecordStore(os.path.join(root, "store"))
        reg = Registry(path=os.path.join(root, "tuned_configs.json"))
        reg.put("tpu_v5e", WL_A, CFG_A, 100.0)
        shim = types.SimpleNamespace(store=store, registry=reg)

        with HubServer(root, hub=shim, readers=2, tune_on_miss=False,
                       heartbeat_s=0.05, hb_grace_s=0.5) as srv:
            victim = srv._readers[0]
            old_port = victim.port
            victim.proc.kill()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if srv.respawns >= 1 and srv._readers[0].port != old_port:
                    break
                time.sleep(0.1)
            assert srv.respawns >= 1, "watchdog never respawned the reader"
            eps = json.load(open(endpoints_path(root)))["readers"]
            assert all(ep["port"] != old_port for ep in eps), (
                "endpoints file still advertises the dead reader")
            # a client pointed at the STALE endpoint must fail over
            with HubClient(root=root,
                           endpoints=[{"rid": 0, "port": old_port}]) as c:
                r = c.get_config("tpu_v5e", WL_A, tune=False)
                assert r.source in ("registry", "cache")
                assert r.config.knobs == CFG_A.knobs


class TestStatsColumns:
    def test_print_stats_serving_columns(self, tmp_path, capsys):
        root = str(tmp_path / "hub")
        hub = TuningHub(root, torch_device="cpu")
        hub.registry.put("tpu_v5e", WL_A, CFG_A, 100.0)
        hub.get_config("tpu_v5e", WL_A)
        hub.get_config("tpu_v5e", WL_A)
        launch_hub.print_stats(root, hub=hub)
        out = capsys.readouterr().out
        assert "serving cache:" in out
        assert "hit-rate=0.500" in out      # 1 LRU hit / 2 lookups
        assert "p50-ms" in out and "p99-ms" in out
        # the hit row reflects the two recorded hit latencies
        hit_row = next(ln for ln in out.splitlines()
                       if ln.strip().startswith("hit "))
        assert " 2 " in hit_row
        assert "live readers" not in out    # no server published endpoints

    def test_print_stats_live_reader_columns(self, tmp_path, capsys):
        """With a farm up, `--stats` adds the farm's health and one row per
        reader, queried over the serving RPC."""
        root = str(tmp_path / "hub")
        hub = TuningHub(root, torch_device="cpu")
        hub.registry.put("tpu_v5e", WL_A, CFG_A, 100.0)
        with HubServer(root, hub=hub, readers=2, monitor=False) as srv:
            with HubClient(root=root, endpoints=[srv.endpoints()[1]]) as c:
                for _ in range(3):
                    c.get_config("tpu_v5e", WL_A, tune=False)
            launch_hub.print_stats(root, hub=hub, drift=False)
        out = capsys.readouterr().out
        assert "farm health: 2/2 alive, respawns=0, monitor=off" in out
        assert "live readers (2 endpoint(s)):" in out
        rows = {ln.split()[0]: ln.split() for ln in out.splitlines()
                if ln.strip()[:1].isdigit() and "endpoint" not in ln}
        assert rows["1"][1] == "3" and rows["1"][2] == "0.667"
        assert rows["0"][1] == "0" and rows["0"][2] == "-"


# --- across packages -------------------------------------------------------

FRAMES = [
    {"op": "get_config", "device": "tpu_v5e",
     "workload": protocol.workload_to_wire(WL_A), "tune": True},
    {"ok": True, "rid": 1, "cache_hit": False, "source": "registry",
     "knobs": protocol.config_to_wire(CFG_B), "throughput_gflops": 321.5},
    {"ok": False, "error": "unknown op 'xé中'", "nested": [[1.0, None]]},
]


def _wire_bytes(send, obj) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(10)
        send(a, obj)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)


@pytest.mark.parametrize("obj", FRAMES, ids=["request", "reply", "error"])
def test_frames_identical_across_packages(obj):
    mine = _wire_bytes(protocol.send_frame, obj)
    ref = _wire_bytes(j_protocol.send_frame, obj)
    assert mine == ref
    for send, recv in ((protocol.send_frame, j_protocol.recv_frame),
                       (j_protocol.send_frame, protocol.recv_frame)):
        a, b = socket.socketpair()
        with a, b:
            b.settimeout(10)
            send(a, obj)
            assert recv(b) == obj
    assert protocol.MAX_FRAME == j_protocol.MAX_FRAME
    assert j_protocol.workload_to_wire(J_WL_A) == \
        protocol.workload_to_wire(WL_A)


def _serve_root(root: str, pkg: str):
    """A registry winner for A and a store-only record for C, written by
    one package; the other reads the same files."""
    if pkg == "port":
        store = RecordStore(os.path.join(root, "store"))
        reg = Registry(path=os.path.join(root, "tuned_configs.json"))
        store.put("tpu_v5e", WL_C, CFG_B, 50.0)
        reg.put("tpu_v5e", WL_A, CFG_A, 100.0)
    else:
        from repro.autotune.space import default_config as j_default
        store = JStore(os.path.join(root, "store"))
        reg = JRegistry(path=os.path.join(root, "tuned_configs.json"))
        store.put("tpu_v5e", J_WL_C, JPC.make(**dict(CFG_B.knobs)), 50.0)
        reg.put("tpu_v5e", J_WL_A, j_default(J_WL_A), 100.0)
    store.flush()
    reg.save()
    return types.SimpleNamespace(store=store, registry=reg)


@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_each_client_served_by_either_server(server_pkg, tmp_path):
    """The reference's client on the port's server, and the port's client
    on the reference's: the same sources and knobs as the server's own
    client gets."""
    from repro.hub.serving.client import HubClient as JClient
    from repro.hub.serving.server import HubServer as JServer
    root = str(tmp_path / "hub")
    shim = _serve_root(root, server_pkg)
    server = HubServer if server_pkg == "port" else JServer
    seen = {}
    with server(root, hub=shim, readers=1, tune_on_miss=False,
                monitor=False):
        for pkg, client, wls in (("port", HubClient, (WL_A, WL_C)),
                                 ("reference", JClient, (J_WL_A, J_WL_C))):
            with client(root=root, timeout_s=30.0) as c:
                assert c.ping()
                rows = [c.get_config("tpu_v5e", wl, tune=False)
                        for wl in (wls[0], wls[0], wls[1])]
                seen[pkg] = [(r.source, dict(r.config.knobs)) for r in rows]
    # the reference's client reads through the port client's warm LRU on
    # the one reader
    assert seen["port"] == [("registry", dict(CFG_A.knobs)),
                            ("cache", dict(CFG_A.knobs)),
                            ("store", dict(CFG_B.knobs))]
    assert seen["reference"] == [("cache", dict(CFG_A.knobs)),
                                 ("cache", dict(CFG_A.knobs)),
                                 ("store", dict(CFG_B.knobs))]


def test_tenset_pretrain_tune_on_miss_same_winner_both_servers(tmp_path):
    """An unfaked tune-on-miss through each package's server, each writer
    hub under `tenset-pretrain` with params from one `.npz`: the two farms
    serve the same winner, each to the other package's client."""
    from repro.configs.moses import CostModelConfig as JCfg
    from repro.configs.moses import MosesConfig as JMoses
    from repro.core.cost_model import MLPCostModel as JMLP
    from repro.hub import TuningHub as JHub
    from repro.hub import bootstrap_store as j_bootstrap
    from repro.hub.serving.client import HubClient as JClient
    from repro.hub.serving.server import HubServer as JServer
    from repro_torch.configs.moses import CostModelConfig as TCfg
    from repro_torch.configs.moses import MosesConfig as TMoses

    cm = dict(hidden_dims=(32, 32), batch_size=64, rank_pairs_per_batch=256)
    moses = dict(online_epochs=2, adaptation_epochs=2, population_size=32,
                 evolution_rounds=2, top_k_measure=8)
    jroot = str(tmp_path / "jhub")
    jstore = JStore(os.path.join(jroot, "store"))
    j_bootstrap(jstore, ("tpu_v5e", "tpu_edge", "tpu_lite"),
                [J_WL_A, JWorkload("matmul", (512, 256, 128), name="b")],
                programs_per_task=16)
    model = JMLP(JCfg(**cm))
    params, _ = model.train(model.init(jax.random.PRNGKey(0)),
                            jstore.records("tpu_v5e"), epochs=3)
    jstore.save_model_params("tpu_v5e", params, "mlp",
                             lineage={"trigger": "pretrain"})
    troot = str(tmp_path / "thub")
    shutil.copytree(jroot, troot)
    kw = dict(strategy="tenset-pretrain", trials_per_task=12, seed=1)
    ref = JHub(jroot, moses_cfg=JMoses(cost_model=JCfg(**cm), **moses), **kw)
    mine = TuningHub(troot, moses_cfg=TMoses(cost_model=TCfg(**cm), **moses),
                     torch_device="cpu", **kw)
    target = "tpu_v5e_pro"
    with JServer(jroot, hub=ref, readers=1, monitor=False), \
            HubServer(troot, hub=mine, readers=1, monitor=False):
        with HubClient(root=jroot, tune_timeout_s=120.0) as c:
            on_ref = c.get_config(target, WL_A, tune=True)
        with JClient(root=troot, tune_timeout_s=120.0) as c:
            on_port = c.get_config(target, J_WL_A, tune=True)
    assert on_ref.source == on_port.source == "tuned"
    assert dict(on_port.config.knobs) == dict(on_ref.config.knobs)
    assert on_port.throughput_gflops == on_ref.throughput_gflops
    assert mine.stats.to_dict() == ref.stats.to_dict()
    assert mine.stats.jobs == 1 and mine.stats.measurements > 0
    assert mine.registry.entry(target, WL_A.key()) == \
        ref.registry.entry(target, J_WL_A.key())


def test_spawned_readers_and_clients_load_no_torch(tmp_path):
    """The reader contract of the `sched` farm's workers: no reader and no
    load-generator client imports torch (none maps its library, each
    reports `torch` absent from `sys.modules`)."""
    assert "torch" in sys.modules        # this process has it
    root = str(tmp_path / "hub")
    shim = _serve_root(root, "port")
    pairs = [["tpu_v5e", protocol.workload_to_wire(WL_A)],
             ["tpu_v5e", protocol.workload_to_wire(WL_C)]]
    with HubServer(root, hub=shim, readers=2, tune_on_miss=False,
                   monitor=False) as srv:
        for r in srv._readers:
            assert not _maps_torch(r.proc.pid), r.rid
        for ep in srv.endpoints():
            with HubClient(root=root, endpoints=[ep]) as c:
                assert c.stats()["torch_loaded"] is False
        procs, out_q = _spawn(launch_hub._serve_client_main,
                              [(root, 0, 0.5, Q, pairs)])
        hammer = _collect(procs, out_q)
        procs, out_q = _spawn(launch_hub._tune_client_main,
                              [(root, 1, pairs, Q)])
        asked = _collect(procs, out_q)
    assert hammer[0]["torch_loaded"] is False and hammer[0]["requests"] > 0
    assert hammer[0]["errors"] == 0
    assert asked[0]["torch_loaded"] is False and not asked[0]["errors"]
    # no writer: tune=True falls back to the registry and the store
    assert sorted((a["source"], a["key"]) for a in asked[0]["answers"]) == \
        sorted([("registry", WL_A.key()), ("store", WL_C.key())])


def test_launch_hub_module_loads_no_torch():
    """Importing the launcher (what a spawned load generator does) and
    `--help` load no torch; only the hub it builds does."""
    import subprocess
    code = ("import sys\n"
            "import repro_torch.launch.hub, repro_torch.launch.obs\n"
            "import repro_torch.hub.serving.server\n"
            "import repro_torch.hub.serving.client\n"
            "print('torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


@pytest.mark.parametrize("argv", [["--smoke", "--serve"], ["--serve"]])
def test_launch_hub_serve_on_cpu(argv, tmp_path, capsys):
    """`--smoke --serve` (the CI leg) and `--serve --clients 2` run with
    the writer hub on the CPU."""
    root = str(tmp_path / "hub")
    extra = ["--clients", "2", "--serve-seconds", "1"] \
        if argv == ["--serve"] else []
    if argv == ["--serve"]:
        _serve_root(root, "port")
    assert launch_hub.main(argv + extra + ["--root", root,
                                           "--torch-device", "cpu"]) == 0
    out = capsys.readouterr().out
    if "--smoke" in argv:
        assert "[serve-smoke] OK" in out
        assert "second get_config: source=cache" in out
    else:
        assert "0 error(s)" in out and "QPS" in out


def test_chip_smoke_hub_serve_path_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `hub_serve_path` at the smoke config and the dry-run
    budget on the CPU, after its `hub_path` on the same root: registry hits,
    tune-on-miss for tpu_v6e from four client processes (one job per key),
    the hammer, the reader kill with exactly one respawn alert, no torch in
    any reader or client, `launch.obs` live and from disk; then the served
    winners launch (the plain versions here)."""
    import importlib.util
    from pathlib import Path

    import repro_torch.configs as t_configs
    from repro_torch.autotune import registry as t_registry
    from repro_torch.configs import get_smoke_config

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(t_configs, "get_config", get_smoke_config)
    registry_file = str(tmp_path / "tuned_configs_torch.json")
    monkeypatch.setattr(t_registry, "_DEFAULT_PATH", registry_file)
    open(registry_file, "w").write("{}")
    root = str(tmp_path / "hub")
    smoke.drive_hub_path("cpu", "recurrentgemma-2b", root, trials=8,
                         dry_run=True)
    cfg, tasks, served, line, obs_runs = smoke.drive_hub_serve_path(
        "cpu", "recurrentgemma-2b", root, trials=8, dry_run=True,
        hammer_s=1.5)
    assert [wl.name for wl in tasks] == ["qkv_proj", "self_attn"]
    assert line["act1_sources"] == {"registry": 2, "cache": 2}
    assert sorted(k for job in line["jobs"] for k in job) == \
        sorted(wl.key() for wl in tasks)
    assert line["writer_params_on"] == ["cpu"] and line["measurements"] > 0
    assert line["respawns"] == 1 and line["qps"] > 0
    assert line["alerts"] == [{"slo": "reader-respawns", "state": "firing"},
                              {"slo": "reader-respawns", "state": "ok"}]
    assert not any(any(v) for v in line["torch_mapped"].values())
    assert [r["argv"][0] for r in obs_runs] == ["--watch", "--explain",
                                                "--explain"]
    calls = smoke.launch_tuned(cfg, types.SimpleNamespace(registry=served),
                               "cpu", seed=8, device=smoke.SERVE_TARGET,
                               workloads=tasks)
    for wl, _, out in calls:
        assert torch.isfinite(out.float()).all(), wl.name
    json.dumps(line)
