"""The rest of serving in the port against the JAX package, on the CPU:

- batch buckets: the port's `Servable` against the JAX `Servable` at
  batches 1 to 4097, with the default buckets and custom ones, for
  xDeepFM (the CIN through its plain version), DCN on the fused engine and
  DIN (tolerance 1e-5: float32 sums in another order);
- the graph bookkeeping, with CUDA graphs stood in for (`stand_in_graphs`):
  one capture per padded signature, none again for a repeat, a new one for
  a new DIN history length or a group past the largest bucket, and each
  signature's lock held through its replay while twelve threads send mixed
  batches;
- the NumPy engine against the JAX one and against the port's `Servable`
  for the CTR zoo on both engines (``rtol 2e-4, atol 2e-6``, the JAX test's
  own: BLAS products in another order, batch norm folded);
- the fronts: REST, gRPC and the socket in the JSON, NPZ1 and RAW1 formats
  against the port's `Servable` and the JAX fronts' answers, errors on each
  front, the socket's frame limit, the micro-batcher's timed coalescing,
  and ``train_ctr serve`` from the command line on all three ports beside
  the JAX command.
"""

import os
import queue
import re
import socket
import struct
import subprocess
import sys
import threading
import urllib.error

import jax
import numpy as np
import pytest

from recsys_tpu.core.config import CriteoConfig as JCriteo
from recsys_tpu.core.config import ModelConfig as JModel
from recsys_tpu.data import criteo
from recsys_tpu.models.api import make_model as jmake
from recsys_tpu.serve import client as jclient
from recsys_tpu.serve import export as jexport
from recsys_tpu.serve import fastsock as jfastsock
from recsys_tpu.serve import server as jserver
from recsys_tpu_torch.serve import client, export, fastsock, server
from recsys_tpu_torch.train import step_graph
from test_torch_graph_step import stand_in_graphs  # noqa: F401 (fixture)
from test_torch_xdeepfm import randomize

VOCABS = (50,) * 20 + (3000,) * 6
JCFG = JCriteo(cat_vocabs=VOCABS)
MODELS = {
    "xdeepfm": dict(name="xdeepfm", embedding_dim=4, cin_layers=(5, 3),
                    deep_layers=(8, 8)),
    "dcn_fused": dict(name="dcn", embedding_dim=4, deep_layers=(8, 8),
                      cross_layers=2, emb_engine="fused"),
}
DIN = dict(name="din", embedding_dim=8, attention_layers=(8, 4),
           mlp_layers=(16, 8), use_bn=False)
DIN_VOCABS = {"item_vocab": 200, "cate_vocab": 10}
TOL = 1e-5
NP_TOL = dict(rtol=2e-4, atol=2e-6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _export(d, key, **over):
    """A JAX export of seeded random weights (every branch alive)."""
    if key == "din":
        cfg = JModel(**DIN)
        model = jmake("din", cfg=cfg, **DIN_VOCABS)
        params, state = randomize(model.init(jax.random.key(0)), 1)
        jexport.export_servable(d, "din", params, state, cfg,
                                factory_kwargs=DIN_VOCABS)
        return d
    cfg = JModel(**dict(MODELS.get(key, dict(name=key, embedding_dim=4,
                                              deep_layers=(8, 8),
                                              cin_layers=(5, 3),
                                              cross_layers=2)), **over))
    params, state = randomize(jmake(cfg.name, JCFG, cfg).init(
        jax.random.key(0)), 2)
    jexport.export_servable(d, cfg.name, params, state, cfg, JCFG)
    return d


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    return {key: _export(str(tmp_path_factory.mktemp(key)), key)
            for key in list(MODELS) + ["din"]}


def _features(key, n, seed=0, p=6):
    if key == "din":
        rng = np.random.default_rng(seed)
        return {"i_id": rng.integers(1, 200, n).astype(np.int32),
                "i_cate": rng.integers(1, 10, n).astype(np.int32),
                "hist_iid": rng.integers(0, 200, (n, p)).astype(np.int32),
                "hist_cate": rng.integers(0, 10, (n, p)).astype(np.int32)}
    d = criteo.synthetic_criteo(n, JCFG, start_row=1000 * seed)
    return {"ids": d["ids"], "dense": d["dense"]}


def _spy_rows(sv):
    """The padded row counts of ``sv``'s device calls."""
    rows, predict = [], sv._predict

    def spy(params, state, batch):
        rows.append(len(next(iter(batch.values()))))
        return predict(params, state, batch)

    sv._predict = spy
    return rows


# ------------------------------------------------------------- buckets

@pytest.mark.parametrize("key", ["xdeepfm", "dcn_fused", "din"])
def test_buckets_match_the_jax_servable(exports, key):
    jsv = jexport.Servable(exports[key])
    sv = export.Servable(exports[key], device="cpu")
    assert sv.buckets == jsv.buckets == export.DEFAULT_BUCKETS
    rows = _spy_rows(sv)
    for n in (1, 5, 8, 9, 300, 4097):
        feats = _features(key, n, seed=n)
        got = sv.predict(feats)
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, jsv.predict(feats), atol=TOL,
                                   rtol=0)
    assert rows == [1, 8, 8, 64, 1024, 8192]
    # custom buckets, given in any order
    jsv = jexport.Servable(exports[key], buckets=(4, 16))
    sv = export.Servable(exports[key], device="cpu", buckets=(16, 4))
    rows = _spy_rows(sv)
    for n in (3, 16, 17, 40):
        feats = _features(key, n, seed=n + 1)
        np.testing.assert_allclose(sv.predict(feats), jsv.predict(feats),
                                   atol=TOL, rtol=0)
    assert rows == [4, 16, 32, 48]


def test_padding_repeats_a_checked_row(exports):
    sv = export.Servable(exports["xdeepfm"], device="cpu", buckets=(8,))
    feats = _features("xdeepfm", 3)
    padded = sv._pad(sv.check(feats), 8)
    assert padded["ids"].dtype == np.int64 and padded["ids"].shape == (8, 39)
    np.testing.assert_array_equal(padded["ids"][3:],
                                  np.repeat(feats["ids"][-1:], 5, 0))
    bad = dict(feats, ids=feats["ids"].copy())
    bad["ids"][-1, 30] = 3000                   # field 30's vocab is 3000
    with pytest.raises(ValueError):
        sv.predict(bad)
    assert sv.predict({"ids": feats["ids"][:0],
                       "dense": feats["dense"][:0]}).shape == (0,)
    with pytest.raises(ValueError, match="engine"):
        export.Servable(exports["xdeepfm"], device="cpu", engine="xla")
    with pytest.raises(ValueError, match="graphed=True"):
        export.Servable(exports["xdeepfm"], device="cpu", graphed=True)


# --------------------------------------------------- graph bookkeeping

def test_one_capture_per_padded_signature(exports, stand_in_graphs):
    sv = export.Servable(exports["din"], device="cpu", buckets=(8, 64),
                         graphed=True)
    eager = export.Servable(exports["din"], device="cpu", buckets=(8, 64),
                            graphed=False)
    assert sv.graphed and not eager.graphed
    sv.warmup()                               # every bucket, at P = 32
    assert len(stand_in_graphs) == sv.captures == 2
    assert all(name.startswith("Servable(din, ") for name in stand_in_graphs)
    for n, p, new in [(3, 32, 0), (9, 32, 0), (3, 32, 0), (3, 5, 1),
                      (7, 5, 0), (65, 32, 1), (100, 32, 0), (9, 5, 1)]:
        feats = _features("din", n, seed=n + p, p=p)
        before = sv.captures
        got = sv.predict(feats)
        assert sv.captures - before == new, (n, p)
        np.testing.assert_array_equal(got, eager.predict(feats))
    # P = 5 at 8 and 64 rows, and 65 rows (a multiple of the largest)
    assert sv.captures == len(stand_in_graphs) == 2 + 3
    assert eager.captures == 0


def test_each_signature_replays_under_its_lock(exports, stand_in_graphs,
                                               monkeypatch):
    """Twelve threads on mixed batches: each answer is its own rows', and
    every replay runs under its signature's lock."""
    sv = export.Servable(exports["xdeepfm"], device="cpu", buckets=(8, 64),
                         graphed=True)
    eager = export.Servable(exports["xdeepfm"], device="cpu",
                            buckets=(8, 64), graphed=False)
    sv.warmup()
    replay = step_graph.StepGraph.replay

    def checked_replay(graph):
        (entry,) = [e for e in sv._graphs.values() if e.graph is graph]
        assert entry.lock.locked()
        replay(graph)

    monkeypatch.setattr(step_graph.StepGraph, "replay", checked_replay)
    reqs = [_features("xdeepfm", 1 + (13 * i) % 90, seed=i)
            for i in range(48)]
    want = [eager.predict(r) for r in reqs]
    got: dict = {}
    errors: queue.Queue = queue.Queue()
    start = threading.Barrier(12)

    def client_thread(t):
        try:
            start.wait(30)
            for i in range(t, len(reqs), 12):
                got[i] = sv.predict(reqs[i])
        except Exception as e:          # reported below
            errors.put(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client_thread, args=(t,))
                   for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors.empty(), errors.get()
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i], w, err_msg=f"request {i}")
    # 1..90 rows: buckets 8 and 64 from the warm-up, then 128 once
    assert sv.captures == 3


# --------------------------------------------------------- numpy engine

NUMPY_CASES = [(m, e) for m in ("fm", "deepfm", "dnn", "dcn", "xdeepfm",
                                "wide") for e in ("split", "fused")]


@pytest.mark.parametrize("name,engine,use_bn",
                         [(m, e, True) for m, e in NUMPY_CASES]
                         + [("deepfm", "split", False)],
                         ids=[f"{m}-{e}" for m, e in NUMPY_CASES]
                         + ["deepfm-no-bn"])
def test_numpy_engine_matches_jax_and_the_servable(tmp_path, name, engine,
                                                   use_bn):
    d = _export(str(tmp_path), name, emb_engine=engine, use_bn=use_bn)
    feats = _features(name, 37, seed=3)
    mine = export.Servable(d, device="cpu", engine="numpy")
    assert mine.engine == "numpy"
    got = mine.predict(feats)
    assert got.shape == (37,) and got.dtype == np.float32
    assert float(np.std(got)) > 1e-3
    np.testing.assert_allclose(
        got, jexport.Servable(d, engine="numpy").predict(feats), **NP_TOL)
    np.testing.assert_allclose(
        got, export.Servable(d, device="cpu").predict(feats), **NP_TOL)


def test_numpy_engine_refuses_din(exports):
    with pytest.raises(NotImplementedError):
        export.Servable(exports["din"], device="cpu", engine="numpy")


# ---------------------------------------------------------------- fronts

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(mod_server, mod_fastsock, sv):
    """REST, gRPC and the socket on one micro-batcher → (ports, stop)."""
    rest, batcher = mod_server.make_rest_server(sv, 0)
    threading.Thread(target=rest.serve_forever, daemon=True).start()
    grpc_port = _free_port()
    grpc_srv, _ = mod_server.make_grpc_server(sv, grpc_port, batcher)
    grpc_srv.start()
    sock = mod_fastsock.SocketServer(sv, 0, batcher)
    sock.start()

    def stop():
        rest.shutdown()
        rest.server_close()
        grpc_srv.stop(0)
        sock.shutdown()
        batcher.stop()

    return (rest.server_address[1], grpc_port, sock.port), stop


@pytest.fixture(scope="module")
def fronts(exports):
    pytest.importorskip("grpc")
    sv = export.Servable(exports["xdeepfm"], device="cpu")
    jsv = jexport.Servable(exports["xdeepfm"])
    ports, stop = _serve(server, fastsock, sv)
    jports, jstop = _serve(jserver, jfastsock, jsv)
    yield sv, ports, jports
    stop()
    jstop()


def _ask(who, ports, body):
    """One prepared body through each front of one package."""
    cl, fs = (client, fastsock) if who == "port" else (jclient, jfastsock)
    rest, grpc_port, sock_port = ports
    conn = fs.SocketClient(sock_port)
    try:
        on_socket = conn.send(body)
    finally:
        conn.close()
    return {"rest": cl.rest_send(rest, body),
            "grpc": cl.grpc_send(cl.make_grpc_stub(grpc_port), body),
            "socket": on_socket}


@pytest.mark.parametrize("fmt", ["json", "npz", "raw"])
def test_each_front_answers_as_the_jax_fronts(fronts, fmt):
    sv, ports, jports = fronts
    feats = _features("xdeepfm", 13, seed=7)
    body = client.prepare_body(feats, fmt)
    want = sv.predict(feats)
    theirs = _ask("jax", jports, body)
    for front, got in _ask("port", ports, body).items():
        assert got.shape == (13,), front
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                   err_msg=front)
        np.testing.assert_allclose(got, theirs[front], atol=TOL, rtol=0,
                                   err_msg=front)


def test_grpc_calls_and_pipelining(fronts):
    sv, (_, grpc_port, _), (_, jgrpc_port, _) = fronts
    reqs = [_features("xdeepfm", 2 + i, seed=20 + i) for i in range(6)]
    np.testing.assert_allclose(client.grpc_predict(grpc_port, reqs[0]),
                               jclient.grpc_predict(jgrpc_port, reqs[0]),
                               atol=TOL, rtol=0)
    stub = client.make_grpc_stub(grpc_port)
    outs = client.grpc_predict_pipelined(
        stub, [client.prepare_body(r, "raw") for r in reqs])
    for r, o in zip(reqs, outs, strict=True):
        np.testing.assert_allclose(o, sv.predict(r), atol=1e-6, rtol=0)
    fut = client.grpc_send_future(stub, client.prepare_body(reqs[1], "npz"))
    np.testing.assert_allclose(client.grpc_future_result(fut),
                               sv.predict(reqs[1]), atol=1e-6, rtol=0)


def test_every_front_rejects_an_id_out_of_range(fronts):
    import grpc

    sv, (rest, grpc_port, sock_port), _ = fronts
    bad = _features("xdeepfm", 3, seed=9)
    bad["ids"][1, 30] = 3000                   # field 30's vocab is 3000
    body = client.prepare_body(bad, "raw")
    with pytest.raises(urllib.error.HTTPError) as e:
        client.rest_send(rest, body)
    assert e.value.code == 400
    with pytest.raises(grpc.RpcError) as e:
        client.grpc_send(client.make_grpc_stub(grpc_port), body)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "ValueError" in e.value.details()
    with fastsock.SocketClient(sock_port) as conn:
        with pytest.raises(RuntimeError, match="ValueError"):
            conn.send(body)
        good = _features("xdeepfm", 3, seed=10)          # still served
        np.testing.assert_allclose(conn.predict(good, "raw"),
                                   sv.predict(good), atol=1e-6, rtol=0)


def test_the_socket_refuses_an_oversized_frame(fronts):
    _, (_, _, sock_port), _ = fronts
    with socket.create_connection(("127.0.0.1", sock_port)) as conn:
        # a lone header announcing more than the limit: an error frame
        # comes back at once (nothing allocated), then the server closes
        conn.sendall(struct.pack(">I", fastsock.MAX_FRAME_BYTES + 1))
        (length,) = struct.unpack(">I", fastsock._recv_exact(conn, 4))
        assert b"exceeds max" in fastsock._recv_exact(conn, length)
        assert conn.recv(1) == b""


def test_the_micro_batcher_coalesces_within_its_timeout(exports):
    sv = export.Servable(exports["xdeepfm"], device="cpu")
    calls = []

    class Counting:
        check = sv.check

        def predict(self, features):
            calls.append(len(features["ids"]))
            return sv.predict(features)

    for max_batch, groups in ((4096, [16]), (8, [8, 8])):
        calls.clear()
        mb = server._MicroBatcher(Counting(), max_batch=max_batch,
                                  timeout_ms=500.0)
        reqs = [_features("xdeepfm", 4, seed=30 + i) for i in range(4)]
        out: dict = {}
        mb._inline.acquire()          # every request takes the queue
        try:
            threads = [threading.Thread(
                target=lambda i=i: out.__setitem__(i, mb.predict(reqs[i])))
                for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
        finally:
            mb._inline.release()
            mb.stop()
        assert not mb.thread.is_alive()
        assert sorted(calls) == groups and mb.largest_group == max(groups)
        for i, r in enumerate(reqs):
            np.testing.assert_allclose(out[i], sv.predict(r), atol=1e-6,
                                       rtol=0)


def test_benchmark_serving_reports_latency_and_auc(exports):
    sv = export.Servable(exports["xdeepfm"], device="cpu")
    d = criteo.synthetic_criteo(64, JCFG, start_row=77)
    labels = d.pop("label")
    out = client.benchmark_serving(sv.predict, d, labels, warmup=1, iters=3)
    want = jclient.benchmark_serving(sv.predict, d, labels, warmup=1,
                                     iters=3)
    assert out.keys() == want.keys() and out["batch"] == 64
    assert out["auc"] == pytest.approx(want["auc"], abs=1e-12)


# ---------------------------------------------------- the command line

def _start(cmd, env=None):
    """Start a serving command; → (process, {front: port}, the lines it
    printed up to its serving line)."""
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def drain():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=drain, daemon=True).start()
    seen = []
    while True:
        try:
            line = lines.get(timeout=240)
        except queue.Empty:
            break
        if line is None:
            break
        seen.append(line)
        m = re.search(r"REST:(\d+) gRPC:(\d+|none) socket:(\d+)", line)
        if m:
            return proc, dict(zip(("rest", "grpc", "socket"),
                                  m.groups())), seen
    proc.kill()
    proc.wait(30)
    raise AssertionError("no serving line in:\n" + "".join(seen))


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(20)


@pytest.mark.parametrize("engine", ["jit", "numpy"])
def test_serve_cli_answers_on_all_three_ports(exports, engine):
    pytest.importorskip("grpc")
    d = exports["xdeepfm"]
    flags = ["serve", f"--export_dir={d}", "--port=0", "--device=cpu",
             "--buckets=8,64", f"--engine={engine}"]
    procs = []
    try:
        port = _start([sys.executable, "-m",
                       "recsys_tpu_torch.tools.train_ctr"] + flags)
        procs.append(port[0])
        theirs = _start([sys.executable, "-m", "recsys_tpu.tools.train_ctr"]
                        + flags)
        procs.append(theirs[0])
        assert "none" not in (port[1]["grpc"], theirs[1]["grpc"])
        feats = _features("xdeepfm", 21, seed=11)
        body = client.prepare_body(feats, "raw")
        ports = [int(port[1][k]) for k in ("rest", "grpc", "socket")]
        jports = [int(theirs[1][k]) for k in ("rest", "grpc", "socket")]
        got, want = _ask("port", ports, body), _ask("jax", jports, body)
        ref = export.Servable(d, device="cpu").predict(feats)
        tol = NP_TOL if engine == "numpy" else dict(atol=TOL, rtol=0)
        for front in got:
            np.testing.assert_allclose(got[front], want[front], **tol,
                                       err_msg=front)
            np.testing.assert_allclose(got[front], ref, **tol,
                                       err_msg=front)
    finally:
        for proc in procs:
            _stop(proc)


def test_serve_cli_without_grpcio_serves_rest_and_the_socket(exports,
                                                            tmp_path):
    """Where ``grpcio`` is missing, ``serve`` says that it does not serve
    gRPC, and why, and answers over REST and the socket."""
    shim = tmp_path / "shim" / "grpc"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text(
        "raise ModuleNotFoundError(\"No module named 'grpc'\", "
        "name='grpc')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(shim.parent)] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]))
    proc, ports, said = _start(
        [sys.executable, "-m", "recsys_tpu_torch.tools.train_ctr", "serve",
         f"--export_dir={exports['xdeepfm']}", "--port=0", "--device=cpu",
         "--buckets=8,64"], env=env)
    try:
        assert ports["grpc"] == "none"
        assert any("gRPC is not served" in line and "grpc" in line
                   for line in said)
        feats = _features("xdeepfm", 5, seed=12)
        body = client.prepare_body(feats, "raw")
        want = export.Servable(exports["xdeepfm"], device="cpu").predict(
            feats)
        with fastsock.SocketClient(int(ports["socket"])) as conn:
            on_socket = conn.send(body)
        for got in (client.rest_send(int(ports["rest"]), body), on_socket):
            np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    finally:
        _stop(proc)


def test_serve_cli_refuses_a_bad_engine(exports):
    from recsys_tpu_torch.tools import train_ctr

    with pytest.raises(SystemExit, match="engine"):
        train_ctr.main(["serve", f"--export_dir={exports['xdeepfm']}",
                        "--device=cpu", "--engine=xla"])
