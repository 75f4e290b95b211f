"""The port's ``parallel/`` against the JAX package's, on the CPU.

The same seeded batches through both sharded steps: the shard tables
array for array, ``ShardedEngine`` at 1x8 and 2x4 (local and global-rows
step, ``pair`` and ``take``; JAX's ``pallas2`` in interpret mode against
the port's plain ``pair`` on the same per-shard tables), EP masks, a
request whose rows sit on one data shard, and ``ring_scan``: all exact.
The JAX side runs on the eight virtual CPU devices of tests/conftest.py;
the port's meshes repeat ``cpu``.  The kernels themselves are held to
their plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ingress_plus_tpu.compiler.bitap import reference_scan
from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.compiler.ruleset import N_SV, VARIANTS
from ingress_plus_tpu.compiler.seclang import STREAM_INDEX
from ingress_plus_tpu.ops.scan import ScanTables as JaxTables
from ingress_plus_tpu.ops.scan import pad_rows, scan_bytes_jit
from ingress_plus_tpu.parallel import ShardedEngine as JaxSharded
from ingress_plus_tpu.parallel import make_mesh as jax_mesh
from ingress_plus_tpu.parallel import shard_ruleset_tables as jax_shard
from ingress_plus_tpu.parallel.stream import ring_scan as jax_ring
from ingress_plus_tpu_torch.models.engine import DetectionEngine
from ingress_plus_tpu_torch.ops.scan import ScanTables, to_numpy_u32
from ingress_plus_tpu_torch.parallel import (
    ShardedEngine,
    make_mesh,
    shard_ruleset_tables,
)
from ingress_plus_tpu_torch.parallel.mesh import Mesh, mesh_shape
from ingress_plus_tpu_torch.parallel.shard import check_impl
from ingress_plus_tpu_torch.parallel.stream import HALO, ring_scan
from ingress_plus_tpu_torch.weights import BUNDLED_PACK, load_pack

CPU8 = ["cpu"] * 8
ATTACK = b"1' UNION SELECT password FROM users--"


@pytest.fixture(scope="module")
def packs():
    """The committed pack, loaded by each package (packs cross over as
    data)."""
    return JaxRuleset.load(str(BUNDLED_PACK)), load_pack()


def _batch(n_req=8, rows_per_req=2):
    """Rows laid out data-shard-major: request q's rows are contiguous."""
    payloads = [
        b"GET /search?q=1' UNION SELECT password FROM users--",
        b"<script>alert(1)</script>",
        b"; cat /etc/passwd",
        b"plain benign text about shoes and prices",
    ]
    rows, row_req = [], []
    for q in range(n_req):
        for r in range(rows_per_req):
            rows.append(payloads[(q + r) % len(payloads)])
            row_req.append(q)
    tokens, lengths = pad_rows(rows, round_to=64)
    sv = np.zeros((len(rows), N_SV), np.int8)
    a = STREAM_INDEX["args"] * len(VARIANTS)
    sv[:, a:a + len(VARIANTS)] = 1
    return tokens, lengths, np.asarray(row_req, np.int32), sv


def _mixed_sv_batch(seed=7, n_req=8, rows=24):
    """Seeded rows with random stream-variant rows and owners, some
    attack substrings planted: exercises the per-row gate."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(32, 127, size=(rows, 64), dtype=np.uint8)
    for i in range(0, rows, 3):
        atk = [ATTACK, b"<script>alert(1)</script>", b"../../etc/passwd"][
            (i // 3) % 3]
        at = int(rng.integers(0, 64 - len(atk)))
        toks[i, at:at + len(atk)] = np.frombuffer(atk, np.uint8)
    lengths = rng.integers(1, 65, size=(rows,)).astype(np.int32)
    lengths[::3] = 64
    row_req = np.sort(rng.integers(0, n_req, size=(rows,))).astype(np.int32)
    sv = (rng.random((rows, N_SV)) < 0.3).astype(np.int8)
    return toks, lengths, row_req, sv


def _assert_equal(want, got):
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.shape == g.shape and (w == g).all()


# ------------------------------------------------------------------ mesh


def test_mesh_repeats_devices_and_checks_shape():
    m = make_mesh(2, 4, devices=CPU8)
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert mesh_shape(m) == (2, 4)
    assert m.rows[1][3] == torch.device("cpu") and not m.spans_processes
    assert make_mesh(devices=CPU8).shape == {"data": 1, "model": 8}
    assert make_mesh(n_model=2, devices=CPU8).shape == {"data": 4,
                                                        "model": 2}
    with pytest.raises(ValueError):
        make_mesh(3, 3, devices=CPU8)
    with pytest.raises(ValueError):
        Mesh([["cpu", "cpu"], ["cpu"]])


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1, 1)


def test_impl_rule_follows_the_device():
    check_impl("pair", "cpu")
    check_impl("take", "cpu")
    check_impl("pallas2", "cuda")
    check_impl("take", "cuda")
    with pytest.raises(ValueError, match="cannot run"):
        check_impl("pallas2", "cpu")
    with pytest.raises(ValueError, match="cannot run"):
        check_impl("pair", "cuda")
    with pytest.raises(ValueError, match="one of"):
        check_impl("pallas3", "cuda")


# ---------------------------------------------------------------- tables


@pytest.mark.parametrize("n_model", [1, 4, 8])
def test_shard_tables_equal_jax(packs, n_model):
    jcr, cr = packs
    want, got = jax_shard(jcr, n_model), shard_ruleset_tables(cr, n_model)
    assert (got.w_shard, got.k_max) == (want.w_shard, want.k_max)
    for name in want.__dataclass_fields__:
        w, g = getattr(want, name), getattr(got, name)
        if isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and w.shape == g.shape, name
            assert (w == g).all(), name
        else:
            assert w == g, name


def test_shard_scan_tables_hold_the_shard_slice(packs):
    _, cr = packs
    st = shard_ruleset_tables(cr, 4)
    t = st.shard_scan_tables(2, torch.device("cpu"))
    sl = slice(2 * st.w_shard, 3 * st.w_shard)
    assert (to_numpy_u32(t.byte_table) == st.byte_table[:, sl]).all()
    assert (to_numpy_u32(t.class_table) == st.class_table[2]).all()
    assert t.byte_class[256].item() == st.k_max


# ---------------------------------------------------------- sharded step


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
@pytest.mark.parametrize("impl", ["pair", "take"])
def test_sharded_detect_equals_jax(packs, shape, impl):
    """Local mode: shard-local request ids, tenants split on data."""
    jcr, cr = packs
    n_data, n_model = shape
    tokens, lengths, row_req, row_sv = _batch()
    local = row_req % (8 // n_data)
    tenants = np.zeros((8,), np.int32)
    want = JaxSharded(jcr, jax_mesh(n_data, n_model), scan_impl=impl
                      ).detect(tokens, lengths, local, row_sv, tenants, 8)
    eng = ShardedEngine(cr, make_mesh(n_data, n_model, devices=CPU8),
                        scan_impl=impl)
    got = eng.detect(tokens, lengths, local, row_sv, tenants, 8)
    _assert_equal(want, got)
    assert got[2].max() > 0          # parity must be non-vacuous
    # and the single-device engine on these uniform-sv rows
    single = DetectionEngine(cr, device="cpu").detect(
        tokens, lengths, row_req, row_sv, 8)
    _assert_equal(single, got)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
@pytest.mark.parametrize("impl", ["pair", "take"])
def test_global_rows_step_equals_jax(packs, shape, impl):
    """Global-rows mode (the serving adapter's step) on rows with mixed
    stream-variants and owners."""
    import jax.numpy as jnp

    jcr, cr = packs
    n_data, n_model = shape
    tokens, lengths, row_req, row_sv = _mixed_sv_batch()
    tenants = np.zeros((8,), np.int32)
    jeng = JaxSharded(jcr, jax_mesh(n_data, n_model), scan_impl=impl)
    step = jeng._build_step(impl, global_rows=True)
    want = step(jnp.asarray(tokens), jnp.asarray(lengths),
                jnp.asarray(row_req), jnp.asarray(row_sv),
                jnp.asarray(tenants), num_requests=8)
    eng = ShardedEngine(cr, make_mesh(n_data, n_model, devices=CPU8),
                        scan_impl=impl)
    got = eng.step(tokens, lengths, row_req, row_sv, tenants, 8,
                   global_rows=True)
    _assert_equal(want, [x.numpy() for x in got])
    assert got[0].any()


def test_jax_pallas2_interpret_equals_port_pair(packs):
    """JAX's per-shard Pallas kernel (interpret mode) against the port's
    plain ``pair`` on the same per-shard tables, through the 2x4 step."""
    jcr, cr = packs
    tokens, lengths, row_req, row_sv = _batch()
    local = row_req % 4
    tenants = np.zeros((8,), np.int32)
    jeng = JaxSharded(jcr, jax_mesh(2, 4), scan_impl="take")
    jeng.pallas_interpret = True
    jeng.set_scan_impl("pallas2")
    want = jeng.detect(tokens, lengths, local, row_sv, tenants, 8)
    got = ShardedEngine(cr, make_mesh(2, 4, devices=CPU8),
                        scan_impl="pair").detect(
        tokens, lengths, local, row_sv, tenants, 8)
    _assert_equal(want, got)
    assert got[2].max() > 0


def test_ep_tenant_masking_equals_jax(packs):
    """Tenant 0 sees only sqli rules; tenant 1 sees everything."""
    jcr, cr = packs
    R = cr.n_rules
    sqli = np.asarray([m.rule.attack_class == "sqli" for m in jcr.rules])
    mask = np.zeros((2, R), bool)
    mask[0] = sqli
    mask[1] = True
    tokens, lengths, row_req, row_sv = _batch()
    jeng = JaxSharded(jcr, jax_mesh(1, 8), tenant_rule_mask=mask)
    eng = ShardedEngine(cr, make_mesh(1, 8, devices=CPU8),
                        tenant_rule_mask=mask)
    for tenant in (0, 1):
        tenants = np.full((8,), tenant, np.int32)
        want = jeng.detect(tokens, lengths, row_req, row_sv, tenants, 8)
        got = eng.detect(tokens, lengths, row_req, row_sv, tenants, 8)
        _assert_equal(want, got)
        if tenant == 0:
            assert not got[0][:, ~sqli].any()
    xss = np.asarray([m.rule.attack_class == "xss" for m in jcr.rules])
    assert eng.detect(tokens, lengths, row_req, row_sv,
                      np.ones((8,), np.int32), 8)[0][:, xss].any()


def test_request_on_one_data_shard(packs):
    """Global rows: request 0's rows all sit on data shard 0, request 1's
    on shard 1, and the other segments are empty on each shard.  The
    empty segments read 0 (not INT32_MIN) and the sum over data keeps
    every hit: equal to JAX's step and to one data shard holding every
    row."""
    import jax.numpy as jnp

    jcr, cr = packs
    tokens, lengths, _, row_sv = _batch(n_req=4, rows_per_req=2)
    # 8 rows: rows 0-3 (data shard 0) belong to request 0, rows 4-7
    # (shard 1) to request 1; requests 2 and 3 have no rows at all
    row_req = np.asarray([0, 0, 0, 0, 1, 1, 1, 1], np.int32)
    tenants = np.zeros((4,), np.int32)
    jeng = JaxSharded(jcr, jax_mesh(2, 4), scan_impl="pair")
    want = jeng._build_step("pair", global_rows=True)(
        jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(row_req),
        jnp.asarray(row_sv), jnp.asarray(tenants), num_requests=4)
    eng = ShardedEngine(cr, make_mesh(2, 4, devices=CPU8))
    got = [x.numpy() for x in eng.step(tokens, lengths, row_req, row_sv,
                                       tenants, 4, global_rows=True)]
    _assert_equal(want, got)
    one = ShardedEngine(cr, make_mesh(1, 8, devices=CPU8))
    _assert_equal([x.numpy() for x in one.step(
        tokens, lengths, row_req, row_sv, tenants, 4, global_rows=True)],
        got)
    assert got[0][0].any() and got[0][1].any()
    assert not got[0][2:].any() and (got[2][2:] == 0).all()


def test_detect_rejects_uneven_requests(packs):
    _, cr = packs
    eng = ShardedEngine(cr, make_mesh(2, 4, devices=CPU8))
    tokens, lengths, row_req, row_sv = _batch()
    with pytest.raises(ValueError, match="divisible"):
        eng.detect(tokens, lengths, row_req, row_sv,
                   np.zeros((7,), np.int32), 7)


def test_cpu_mesh_refuses_the_kernel_impl(packs):
    _, cr = packs
    with pytest.raises(ValueError, match="cannot run"):
        ShardedEngine(cr, make_mesh(1, 8, devices=CPU8),
                      scan_impl="pallas2")
    eng = ShardedEngine(cr, make_mesh(1, 8, devices=CPU8))
    assert eng.scan_impl == "pair"
    with pytest.raises(ValueError, match="cannot run"):
        eng.set_scan_impl("pallas2")


# ------------------------------------------------------------- ring scan


@pytest.fixture(scope="module")
def ring_tables(packs):
    jcr, cr = packs
    return (JaxTables.from_bitap(jcr.tables),
            ScanTables.from_bitap(cr.tables, "cpu"))


def test_ring_scan_boundary_attack(packs, ring_tables):
    jt, t = ring_tables
    jcr, _ = packs
    tokens = np.full((1, 256), ord("x"), np.int32)
    atk = b"/etc/passwd"
    tokens[0, 30:30 + len(atk)] = np.frombuffer(atk, np.uint8)  # spans 32
    got = to_numpy_u32(ring_scan(t, make_mesh(1, 8, devices=CPU8), tokens))
    want = reference_scan(jcr.tables, tokens[0].astype(np.uint8).tobytes())
    assert want.any()
    assert (got[0][:want.shape[0]] == want).all()
    assert (got == np.asarray(jax_ring(jt, jax_mesh(1, 8), tokens))).all()


def test_ring_scan_ragged_rows(ring_tables):
    """Rows shorter than the padded width scan exactly their own bytes:
    an attack planted in the padding must not match."""
    jt, t = ring_tables
    rng = np.random.default_rng(23)
    tokens = rng.integers(97, 122, size=(4, 1024), dtype=np.int32)
    lengths = np.asarray([1024, 300, 130, 64], np.int32)
    tokens[0, 380:380 + len(ATTACK)] = np.frombuffer(ATTACK, np.uint8)
    tokens[1, 120:120 + len(ATTACK)] = np.frombuffer(ATTACK, np.uint8)
    tokens[2, 200:200 + len(ATTACK)] = np.frombuffer(ATTACK, np.uint8)
    got = to_numpy_u32(ring_scan(t, make_mesh(1, 8, devices=CPU8), tokens,
                                 lengths))
    want = np.asarray(jax_ring(jt, jax_mesh(1, 8), tokens, lengths=lengths))
    contiguous, _ = scan_bytes_jit(jt, tokens, lengths, gather="take")
    assert (got == want).all()
    assert (got == np.asarray(contiguous)).all()
    assert got[1].any()
    # two meshes of four shards over the same rows agree too
    assert (to_numpy_u32(ring_scan(
        t, make_mesh(2, 4, devices=CPU8), tokens, lengths)) == got).all()


def test_ring_scan_mixed_1mb_batch(ring_tables):
    """A 1 MiB body and a 100 KiB one in one ragged batch over 8 shards,
    with a boundary-spanning attack and one far past the short row's
    end: the JAX package's contiguous scan of the same rows, which
    tests/test_parallel.py holds equal to its ring on these inputs."""
    jt, t = ring_tables
    rng = np.random.default_rng(29)
    L = 1 << 20
    shard = L // 8
    tokens = rng.integers(97, 122, size=(2, L), dtype=np.int32)
    lengths = np.asarray([L, 100 * 1024], np.int32)
    tokens[0, shard - 16:shard - 16 + len(ATTACK)] = np.frombuffer(
        ATTACK, np.uint8)
    tokens[1, 50_000:50_000 + len(ATTACK)] = np.frombuffer(ATTACK, np.uint8)
    tokens[1, 500_000:500_000 + len(ATTACK)] = np.frombuffer(
        ATTACK, np.uint8)
    got = to_numpy_u32(ring_scan(t, make_mesh(1, 8, devices=CPU8), tokens,
                                 lengths))
    contiguous, _ = scan_bytes_jit(jt, tokens, lengths, gather="take")
    assert (got == np.asarray(contiguous)).all()
    assert got[0].any() and got[1].any()


def test_ring_scan_refuses_a_short_slice(ring_tables):
    _, t = ring_tables
    with pytest.raises(ValueError, match="HALO"):
        ring_scan(t, make_mesh(1, 8, devices=CPU8),
                  np.zeros((1, 8 * (HALO - 1)), np.int32))
    with pytest.raises(ValueError, match="does not split"):
        ring_scan(t, make_mesh(1, 8, devices=CPU8),
                  np.zeros((1, 8 * HALO + 1), np.int32))
