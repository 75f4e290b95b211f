"""The port's multi-process tier (``parallel/dcn.py``) on
``torch.distributed``: the gated init, the hybrid mesh's one-process
fallback, batch slicing, and a REAL two-process ``gloo`` run in which
each process feeds only its half of the batch and both receive the
single-device engine's outputs.

Run as a script, this file is that run's worker:
``python tests/test_torch_dcn.py <port> <rank>``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ingress_plus_tpu_torch.parallel.dcn import (  # noqa: E402
    device_duty_summary,
    gather_global,
    hybrid_mesh,
    init_distributed,
    local_batch_bounds,
    make_global,
)

RULES = """
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)union\\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-sqli'"
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)<script" \
    "id:941100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-xss'"
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx /etc/passwd" \
    "id:930120,phase:2,block,severity:CRITICAL,tag:'attack-lfi'"
"""

PAYLOADS = [
    b"GET /search?q=1' UNION SELECT password FROM users--",
    b"<script>alert(1)</script>",
    b"; cat /etc/passwd",
    b"plain benign text about shoes and prices",
]
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture()
def no_dist_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def test_init_distributed_noop_single_process(no_dist_env):
    assert init_distributed(device_type="cpu") is False


def test_init_distributed_world_of_one(no_dist_env, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert init_distributed(device_type="cpu") is False


@pytest.mark.parametrize("env", [
    {"MASTER_ADDR": "127.0.0.1"},                       # incomplete
    {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "x",    # malformed
     "WORLD_SIZE": "2", "RANK": "0"},
    {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1",
     "WORLD_SIZE": "two", "RANK": "0"},
])
def test_init_distributed_rejects_bad_env(no_dist_env, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="distributed env"):
        init_distributed(device_type="cpu")


def test_init_distributed_rejects_bad_rank(no_dist_env):
    with pytest.raises(ValueError, match="rank 3 outside"):
        init_distributed("tcp://127.0.0.1:1", world_size=2, rank=3,
                         device_type="cpu")


def test_hybrid_mesh_single_process_fallback():
    mesh = hybrid_mesh(n_model=4, devices=["cpu"] * 8)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 4}
    assert not mesh.spans_processes


def test_local_batch_bounds_single_process():
    mesh = hybrid_mesh(n_model=4, devices=["cpu"] * 8)
    assert local_batch_bounds(mesh, 64) == (0, 64)
    with pytest.raises(ValueError):
        local_batch_bounds(mesh, 63)


def test_make_and_gather_global_single_process():
    import torch

    mesh = hybrid_mesh(n_model=4, devices=["cpu"] * 8)
    a = np.arange(12).reshape(6, 2)
    assert (make_global(mesh, ("data", None), a, (6, 2)) == a).all()
    t = torch.tensor([[True, False]])
    assert (gather_global(t) == np.array([[True, False]])).all()


def test_duty_summary_shape():
    s = device_duty_summary()
    assert s["process_count"] == 1 and s["process_index"] == 0
    assert s["global_device_count"] == len(s["local_devices"]) >= 1


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_detect():
    """Two ``gloo`` processes, four CPU entries each: the hybrid mesh
    puts the processes on ``data``; each feeds only its own requests;
    the local-rows step gathers the verdicts and the global-rows step
    all-reduces the partials over ``data``.  Both processes must see the
    single-device engine's outputs bit for bit."""
    port = _free_port()
    env = dict(os.environ)
    for k in ENV:
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(rank)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "worker %d failed:\n%s" % (rank, out)
        assert "P%d DCN DETECT OK" % rank in out, out


def _rows_for(requests, global_ids: bool):
    """Two rows per request, request-major (the batcher's layout)."""
    from ingress_plus_tpu_torch.compiler.ruleset import N_SV, VARIANTS
    from ingress_plus_tpu_torch.compiler.seclang import STREAM_INDEX
    from ingress_plus_tpu_torch.ops.scan import pad_rows

    rows, row_req = [], []
    for qi, q in enumerate(requests):
        for r in range(2):
            rows.append(PAYLOADS[(q + r) % len(PAYLOADS)])
            row_req.append(q if global_ids else qi)
    tokens, lengths = pad_rows(rows, max_len=64, round_to=64)
    sv = np.zeros((len(rows), N_SV), np.int8)
    a = STREAM_INDEX["args"] * len(VARIANTS)
    sv[:, a:a + len(VARIANTS)] = 1
    return tokens, lengths, np.asarray(row_req, np.int32), sv


def _worker(port: int, rank: int) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK=str(rank))
    import torch.distributed as dist

    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.models.engine import DetectionEngine
    from ingress_plus_tpu_torch.parallel import ShardedEngine

    assert init_distributed(device_type="cpu"), "distributed init failed"
    assert dist.get_backend() == "gloo"
    cr = compile_ruleset(parse_seclang(RULES))
    mesh = hybrid_mesh(devices=["cpu"] * 4)       # (data=2 procs, model=4)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.spans_processes
    n_req = 8
    lo, hi = local_batch_bounds(mesh, n_req)
    assert (lo, hi) == ((0, 4) if rank == 0 else (4, 8)), (rank, lo, hi)

    # each process prepares ONLY its own requests, shard-local ids
    tokens, lengths, row_req, row_sv = _rows_for(range(lo, hi), False)
    eng = ShardedEngine(cr, mesh)
    R = tokens.shape[0]                            # 8 local rows, 16 global

    def g(spec, arr, shape):
        return make_global(mesh, spec, arr, shape)

    rh, ch, sc = eng.detect(
        g(("data", None), tokens, (2 * R, tokens.shape[1])),
        g(("data",), lengths, (2 * R,)),
        g(("data",), row_req, (2 * R,)),
        g(("data", None), row_sv, (2 * R, row_sv.shape[1])),
        g(("data",), np.zeros((hi - lo,), np.int32), (n_req,)),
        num_requests=n_req)

    ftok, flen, freq, fsv = _rows_for(range(n_req), True)
    single = DetectionEngine(cr, device="cpu")
    rh1, ch1, sc1 = single.detect(ftok, flen, freq, fsv, n_req)
    assert rh.shape == rh1.shape and (rh == rh1).all(), "rule hits differ"
    assert (ch == ch1).all() and (sc == sc1).all()
    assert rh1.any(), "reference found no hits — vacuous test"

    # the global-rows step: global ids, partials all-reduced over data
    gtok, glen, greq, gsv = _rows_for(range(lo, hi), True)
    out = eng.step(gtok, glen, greq, gsv, np.zeros((n_req,), np.int32),
                   n_req, global_rows=True)
    for a, b in zip(out, (rh1, ch1, sc1)):
        assert (a.numpy() == b).all(), "global-rows step differs"
    dist.destroy_process_group()
    print("P%d DCN DETECT OK (%d global hits)" % (rank, int(rh.sum())),
          flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
