"""The port's plain scans against the JAX package's, on the CPU.

Same seeded rows through ``ingress_plus_tpu_torch.ops.scan`` and
``ingress_plus_tpu.ops.scan`` (plus the Pallas pair and byte kernels in
interpret mode).  Tolerance: none — match and state words are integer bit patterns
and must be bit-identical.
"""

import numpy as np
import pytest
import torch

from ingress_plus_tpu.compiler.ruleset import compile_ruleset
from ingress_plus_tpu.compiler.seclang import parse_seclang
from ingress_plus_tpu.ops import scan as jscan
from ingress_plus_tpu.ops.pallas_scan import PallasByteScanner, PallasScanner
from ingress_plus_tpu_torch.compiler.bitap import reference_scan
from ingress_plus_tpu_torch.ops import pair_scan as tpair
from ingress_plus_tpu_torch.ops import scan as tscan
from ingress_plus_tpu_torch.ops import step_scan as tstep

RULES = """
SecRule ARGS "@rx (?i)union\\s+select" "id:1,phase:2,block,severity:CRITICAL,tag:'attack-sqli'"
SecRule ARGS "@rx (?i)<script[^>]*>" "id:2,phase:2,block,severity:CRITICAL,tag:'attack-xss'"
SecRule ARGS "@rx /etc/(?:passwd|shadow)" "id:3,phase:2,block,severity:CRITICAL,tag:'attack-lfi'"
SecRule ARGS "@pm sleep( benchmark( xp_cmdshell load_file(" "id:4,phase:2,block,severity:ERROR,tag:'attack-sqli'"
SecRule ARGS "@rx (?:;|\\|)\\s*(?:cat|ls|id)\\b" "id:5,phase:2,block,severity:ERROR,tag:'attack-rce'"
"""
ONE_RULE = ('SecRule ARGS "@rx (?i)union\\s+select" '
            '"id:1,phase:2,block,severity:CRITICAL"')
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def packs():
    """(JAX ScanTables, port ScanTables) built from one compiled pack."""
    cr = compile_ruleset(parse_seclang(RULES))
    assert cr.tables.n_words > 1
    return (jscan.ScanTables.from_bitap(cr.tables),
            tscan.ScanTables.from_bitap(cr.tables, CPU))


def _mixed_rows(n, seed=0, max_len=300):
    rng = np.random.default_rng(seed)
    attacks = [b"1 union  select password from users",
               b"<script>alert(1)</script>", b"../../etc/passwd",
               b"; cat /etc/hosts", b"sleep(5) or benchmark(9,1)"]
    rows = []
    for i in range(n):
        body = bytes(rng.integers(32, 127,
                                  size=int(rng.integers(1, max_len))))
        if i % 3 == 0:
            a = attacks[i % len(attacks)]
            pos = int(rng.integers(0, max(1, len(body) - len(a))))
            body = body[:pos] + a + body[pos + len(a):]
        rows.append(body)
    return rows


def _ragged_odd_empty():
    rows = [b"", b"x", b"1 union select 2", b"a" * 127 + b"; cat /etc/x",
            b"; cat /etc/hosts!", b"<script>" * 16]
    tokens, _ = jscan.pad_rows(rows, round_to=64)
    # 0 = empty, 1 = one byte, odd values, and full-length (L = 128)
    return tokens, np.asarray([0, 1, 15, 128, 17, 128], np.int32)


def _long_rows():
    rng = np.random.default_rng(11)
    long = bytes(rng.integers(32, 127, size=900))
    rows = [long[:813] + b"1 union select password from users" + long[:77],
            long, b"short ; cat /etc/hosts", long[:500]]
    return jscan.pad_rows(rows, round_to=64)


def _stale_reach_row():
    """49-byte row, TB=8: the odd remainder's half pair must read the dead
    class, never stale reach ('d' planted two chunks before the tail)."""
    row = bytearray(b"a" * 49)
    row[17] = ord("d")
    row[39:49] = b"/etc/passw"
    return jscan.pad_rows([bytes(row)], round_to=64)


CASES = {
    "ragged": lambda: jscan.pad_rows(_mixed_rows(13)),
    "odd_empty_full": _ragged_odd_empty,
    "multi_chunk": _long_rows,
    "stale_reach_49": _stale_reach_row,
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32(x):
    return tscan.to_numpy_u32(x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_pairs_matches_jax(packs, case):
    jt, tt = packs
    tokens, lengths = CASES[case]()
    want_m, want_s = jscan.scan_pairs_jit(jt, tokens, lengths)
    got_m, got_s = tscan.scan_pairs(tt, _t(tokens), _t(lengths))
    np.testing.assert_array_equal(_u32(got_m), np.asarray(want_m))
    np.testing.assert_array_equal(_u32(got_s), np.asarray(want_s))
    # the Pallas pair kernel (raw-byte config, interpret mode): match only
    # — its state for short rows diverges (test_pair_state_contract)
    pm, _ = PallasByteScanner(jt, TB=8, CL=16, MR=8)(
        tokens, lengths, interpret=True)
    np.testing.assert_array_equal(_u32(got_m), np.asarray(pm))
    # the port's scanners on CPU tensors run exactly this plain version
    for scanner in (tpair.ByteScanner(tt), tpair.PairScanner(tt)):
        m, s = scanner(_t(tokens), _t(lengths))
        assert torch.equal(m, got_m) and torch.equal(s, got_s)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_bytes_matches_jax(packs, case):
    jt, tt = packs
    tokens, lengths = CASES[case]()
    want_m, want_s = jscan.scan_bytes_jit(jt, tokens, lengths)
    got_m, got_s = tscan.scan_bytes(tt, _t(tokens), _t(lengths))
    np.testing.assert_array_equal(_u32(got_m), np.asarray(want_m))
    np.testing.assert_array_equal(_u32(got_s), np.asarray(want_s))
    assert np.asarray(want_m).any() or case == "stale_reach_49"


def test_sticky_match_chaining(packs):
    """Chained calls accumulate the sticky match; pair and byte paths
    agree with the JAX chain and with one whole scan."""
    jt, tt = packs
    tokens, lengths = jscan.pad_rows(_mixed_rows(9, seed=3), round_to=64)
    want_m, _ = jscan.scan_bytes_jit(jt, tokens, lengths)
    m1, _ = tscan.scan_pairs(tt, _t(tokens), _t(lengths))
    m2, _ = tscan.scan_pairs(tt, _t(tokens), _t(lengths), match=m1)
    np.testing.assert_array_equal(_u32(m2), np.asarray(want_m))
    jm1, _ = jscan.scan_pairs_jit(jt, tokens, lengths)
    jm2, _ = jscan.scan_pairs_jit(jt, tokens, lengths, match=jm1)
    np.testing.assert_array_equal(_u32(m2), np.asarray(jm2))


def test_scan_bytes_state_carry_across_chunks(packs):
    """The byte path's exact state: a row split at a chunk boundary with
    (state, match) carried equals the whole-row scan, as in JAX."""
    jt, tt = packs
    full = [b"AAAA union  sel" + b"ect BBBB", b"hello /etc/pas" + b"swd zz"]
    a, b = [r[:14] for r in full], [r[14:] for r in full]
    tok, ln = jscan.pad_rows(full, round_to=64)
    want_m, want_s = jscan.scan_bytes_jit(jt, tok, ln)
    ta, la = jscan.pad_rows(a, round_to=64)
    tb, lb = jscan.pad_rows(b, round_to=64)
    m1, s1 = tscan.scan_bytes(tt, _t(ta), _t(la))
    m2, s2 = tscan.scan_bytes(tt, _t(tb), _t(lb), state=s1, match=m1)
    _, js1 = jscan.scan_bytes_jit(jt, ta, la)
    np.testing.assert_array_equal(_u32(s1), np.asarray(js1))
    np.testing.assert_array_equal(_u32(m2), np.asarray(want_m))
    np.testing.assert_array_equal(_u32(s2), np.asarray(want_s))
    assert np.asarray(want_m).any()


def test_pair_state_contract():
    """The pair path returns state 0 for every row shorter than the
    padded L (dead-class padding), the ``scan_pairs`` contract the port's
    kernel keeps.

    The Pallas pair kernel diverges here: its chain stops at the TILE's
    longest row (``pallas_scan.py:284``/``:347``), so that row keeps a
    non-zero state when its length is even and below L — state [16, 0]
    against scan_pairs' [0, 0] on this one-rule pack.  Serving reads only
    the match words, which agree; the divergence is pinned here so a
    change to either side shows up."""
    cr = compile_ruleset(parse_seclang(ONE_RULE))
    jt = jscan.ScanTables.from_bitap(cr.tables)
    tt = tscan.ScanTables.from_bitap(cr.tables, CPU)
    tokens, lengths = jscan.pad_rows([b"xx union selec", b"xx"], round_to=64)
    sc = PallasByteScanner(jt, TB=8, CL=16, MR=8)
    k_m, k_s = sc(tokens, lengths, interpret=True)
    r_m, r_s = sc(tokens, lengths, mode="reference")
    got_m, got_s = tscan.scan_pairs(tt, _t(tokens), _t(lengths))
    np.testing.assert_array_equal(_u32(got_s), [[0], [0]])
    np.testing.assert_array_equal(_u32(got_s), np.asarray(r_s))
    np.testing.assert_array_equal(np.asarray(k_s), [[16], [0]])
    np.testing.assert_array_equal(_u32(got_m), np.asarray(k_m))
    np.testing.assert_array_equal(_u32(got_m), np.asarray(r_m))
    # a full-length row keeps its state on every path
    full = np.frombuffer(b"ab" * 32, np.uint8)[None, :]
    fl = np.asarray([64], np.int32)
    _, js = jscan.scan_pairs_jit(jt, full, fl)
    _, ts = tscan.scan_pairs(tt, _t(full), _t(fl))
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))


def test_full_pack_geometry():
    """The bundled pack's real width (225 words, 58 classes + dead): the
    port's pair and byte scans equal the JAX scans."""
    from ingress_plus_tpu_torch.weights import load_pack

    cr = load_pack()
    jt = jscan.ScanTables.from_bitap(cr.tables)
    tt = tscan.ScanTables.from_bitap(cr.tables, CPU)
    assert (tt.n_words, tt.n_classes) == (225, 58)
    rng = np.random.default_rng(3)
    B, L = 6, 192
    tokens = rng.integers(32, 127, (B, L)).astype(np.uint8)
    atk = b"1' union select password from users -- "
    tokens[0, :len(atk)] = np.frombuffer(atk, np.uint8)
    tokens[4, 100:100 + len(atk)] = np.frombuffer(atk, np.uint8)
    lengths = np.asarray([L, 37, 0, 5, L, 64], np.int32)
    want_m, want_s = jscan.scan_pairs_jit(jt, tokens, lengths)
    got_m, got_s = tscan.scan_pairs(tt, _t(tokens), _t(lengths))
    np.testing.assert_array_equal(_u32(got_m), np.asarray(want_m))
    np.testing.assert_array_equal(_u32(got_s), np.asarray(want_s))
    bm, _ = jscan.scan_bytes_jit(jt, tokens, lengths)
    np.testing.assert_array_equal(_u32(got_m), np.asarray(bm))
    assert np.asarray(want_m)[0].any()


def test_class_pair_tables_match_jax(packs):
    jt, tt = packs
    for name in ("byte_table", "init_mask", "final_mask", "class_table",
                 "pair_reach", "pair_final"):
        np.testing.assert_array_equal(_u32(getattr(tt, name)),
                                      np.asarray(getattr(jt, name)))
    np.testing.assert_array_equal(tt.byte_class.numpy(),
                                  np.asarray(jt.byte_class))


def test_kernel_wrapper_refuses_cpu_tensors(packs):
    """The CUDA kernel's binding launches only on CUDA tensors; CPU
    tensors are the scanners' plain path, never the kernel's."""
    _, tt = packs
    tokens, lengths = _stale_reach_row()
    with pytest.raises(ValueError, match="CUDA"):
        tpair.PAIR_SCAN(_t(tokens), _t(lengths), tt.class_table,
                        tt.init_mask, tt.final_mask,
                        byte_class=tt.byte_class.to(torch.int32))
    assert tpair.PAIR_SCAN.launches == 0


def _carry(B, W, seed):
    """A seeded carried-in state and a sparse sticky match, uint32."""
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    match = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    match[rng.random((B, W)) < 0.9] = 0
    return state, match


@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_scanner_matches_scan_kernel(packs, case, carry):
    """``StepScanner`` on CPU tensors (its plain path) against the JAX
    ``_scan_kernel`` in interpret mode and ``scan_bytes_jit``: match AND
    state bit-identical, from the zero state and from a carried one."""
    jt, tt = packs
    tokens, lengths = CASES[case]()
    state = match = None
    if carry:
        state, match = _carry(tokens.shape[0], tt.n_words, len(case))
    km, ks = PallasScanner(jt, TB=8, CL=16, MR=8)(
        tokens, lengths, state, match, interpret=True)
    bm, bs = jscan.scan_bytes_jit(jt, tokens, lengths, state, match)
    m, s = tstep.StepScanner(tt)(
        _t(tokens), _t(lengths),
        None if state is None else tscan.from_numpy_u32(state, CPU),
        None if match is None else tscan.from_numpy_u32(match, CPU))
    for got, want in ((m, km), (s, ks), (m, bm), (s, bs)):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    if carry:   # a row of length 0 returns its inputs unchanged
        empty = np.asarray(lengths) == 0
        np.testing.assert_array_equal(_u32(s)[empty], state[empty])
        np.testing.assert_array_equal(_u32(m)[empty], match[empty])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_scanner_chained_carry_equals_whole_scan(packs, seed):
    """Rows split at ragged points (0, 1, odd, the whole row) and scanned
    in two calls with (state, match) carried end in the same words as one
    whole-row call — the stream lane's contract — and the match equals
    the numpy oracle's."""
    jt, tt = packs
    rows = _mixed_rows(11, seed=seed)
    rng = np.random.default_rng(seed)
    cuts = [int(rng.integers(0, len(r) + 1)) for r in rows]
    cuts[:4] = [0, 1, min(3, len(rows[2])), len(rows[3])]
    scanner = tstep.StepScanner(tt)
    tok, ln = jscan.pad_rows(rows, round_to=64)
    whole_m, whole_s = scanner(_t(tok), _t(ln))
    ta, la = jscan.pad_rows([r[:c] for r, c in zip(rows, cuts)], round_to=64)
    tb, lb = jscan.pad_rows([r[c:] for r, c in zip(rows, cuts)], round_to=64)
    m1, s1 = scanner(_t(ta), _t(la))
    m2, s2 = scanner(_t(tb), _t(lb), state=s1, match=m1)
    assert torch.equal(m2, whole_m) and torch.equal(s2, whole_s)
    want_m, want_s = jscan.scan_bytes_jit(jt, tok, ln)
    np.testing.assert_array_equal(_u32(whole_m), np.asarray(want_m))
    np.testing.assert_array_equal(_u32(whole_s), np.asarray(want_s))
    cr = compile_ruleset(parse_seclang(RULES))
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(_u32(whole_m)[i],
                                      reference_scan(cr.tables, r))
    assert _u32(whole_m).any()


def test_step_kernel_wrapper_refuses_cpu_tensors(packs):
    """The step kernel's binding launches only on CUDA tensors and
    counts no launch otherwise."""
    _, tt = packs
    tokens, lengths = _stale_reach_row()
    before = tstep.STEP_SCAN.launches
    with pytest.raises(ValueError, match="CUDA"):
        tstep.STEP_SCAN(_t(tokens), _t(lengths), tt.class_table,
                        tt.init_mask, tt.final_mask,
                        byte_class=tt.byte_class.to(torch.int32))
    assert tstep.STEP_SCAN.launches == before == 0


# --- the kernels' split of a row's chain into segments (ops/segments.py) ---

#: a 32-byte literal: with the reduction off it compiles to one factor
#: that fills a whole word (init bit 0, final bit 31), the longest chain
#: a halo must cover
LONG = b"abcdefghijklmnopqrstuvwxyz012345"
HALO_RULES = RULES + (
    'SecRule ARGS "@rx %s" "id:6,phase:2,block,severity:CRITICAL"\n'
    % LONG.decode())
SPLIT_L = 320


@pytest.fixture(scope="module")
def halo_packs():
    """(JAX ScanTables, port ScanTables) of a pack holding a 32-byte
    factor next to the short ones."""
    from ingress_plus_tpu.compiler.reduce import ReductionConfig

    cr = compile_ruleset(parse_seclang(HALO_RULES),
                         reduction=ReductionConfig.off())
    assert int(cr.tables.factor_len.max()) == 32
    return (jscan.ScanTables.from_bitap(cr.tables),
            tscan.ScanTables.from_bitap(cr.tables, CPU))


def _boundary_rows(G, seed, W):
    """Rows of SPLIT_L bytes with lengths at every segment boundary
    (odd and even), the 32-byte literal planted to end on segment starts
    and on the bytes around them, short attacks across boundaries, a
    carried state and a sparse sticky match."""
    L = SPLIT_L
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 31, 32, 33, G - 1, G, G + 1, G + 31, G + 32, G + 33,
               L - 1, L, 2 * G + 1, L, L]
    B = len(lengths)
    tokens = rng.integers(32, 127, (B, L)).astype(np.uint8)
    lit = np.frombuffer(LONG, np.uint8)
    atk = np.frombuffer(b"1 union select /etc/passwd", np.uint8)
    for i in range(B):
        # the literal's last byte on a segment start, one before or after
        end = (i % 3 - 1) + G * (1 + i % 2)
        if 32 <= end + 1 <= L:
            tokens[i, end + 1 - 32:end + 1] = lit
        at = 2 * G - 7 + i % 5    # across the second segment start
        if i % 2 == 0 and at + len(atk) <= L:
            tokens[i, at:at + len(atk)] = atk
    state, match = _carry(B, W, seed)
    return tokens, np.asarray(lengths, np.int32), state, match


def _split_twin(tt, tokens, lengths, state, match, G, halo, pairs=False):
    """Plain twin of the kernels' split: per row, segment 0 from the
    carried state, every later segment warmed up from the zero state over
    the ``halo`` bytes before it (no match recorded there), the segments'
    matches OR-ed into the sticky match, the state from the segment that
    holds the row's end (0 for a row shorter than L on the pair path)."""
    scan = tscan.scan_pairs if pairs else tscan.scan_bytes
    tok = _t(tokens)
    B, L = tok.shape
    n = _t(np.clip(lengths, 0, L).astype(np.int32))
    zero = torch.zeros((B, tt.n_words), dtype=torch.int32)
    S = zero if state is None else tscan.from_numpy_u32(state, CPU)
    M = zero if match is None else tscan.from_numpy_u32(match, CPU)
    start0 = S
    for a in range(0, L, G):
        live = (n > a) | (a == 0)
        seg = torch.where(live, torch.clamp(n, max=a + G) - a, 0)
        start = start0
        if a:
            h = min(halo, a)
            _, start = scan(tt, tok[:, a - h:a],
                            torch.full((B,), h, dtype=torch.int32))
        m, s = scan(tt, tok[:, a:a + G], seg.to(torch.int32), start)
        M = M | torch.where(live[:, None], m, zero)
        S = torch.where((live & (n <= a + G))[:, None], s, S)
    if pairs:
        S = torch.where((n < L)[:, None], zero, S)
    return M, S


@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("G", [32, 96, 128])
def test_torch_split_step_scan_is_exact(halo_packs, G, carry):
    """The step kernel's split (32-byte halo) against the whole-row
    ``scan_bytes_jit`` and the JAX ``_scan_kernel`` in interpret mode:
    match AND state bit-identical at every boundary length."""
    jt, tt = halo_packs
    tokens, lengths, state, match = _boundary_rows(G, G, tt.n_words)
    if not carry:
        state = match = None
    m, s = _split_twin(tt, tokens, lengths, state, match, G, halo=32)
    bm, bs = jscan.scan_bytes_jit(jt, tokens, lengths, state, match)
    km, ks = PallasScanner(jt, TB=8, CL=16, MR=8)(
        tokens, lengths, state, match, interpret=True)
    for got, want in ((m, bm), (s, bs), (m, km), (s, ks)):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert (_u32(m)[:, 0] >> 31).any()   # the 32-byte factor matched


@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("G", [32, 96, 128])
def test_torch_split_pair_scan_is_exact(halo_packs, G, carry):
    """The pair kernel's split (16-pair halo) against the whole-row
    ``scan_pairs`` of the port and of JAX and the Pallas pair scanner's
    reference lowering (match and state); the Pallas kernel in interpret
    mode agrees on the match words."""
    jt, tt = halo_packs
    tokens, lengths, state, match = _boundary_rows(G, G + 1, tt.n_words)
    if not carry:
        state = match = None
    m, s = _split_twin(tt, tokens, lengths, state, match, G, halo=32,
                       pairs=True)
    wm, ws = tscan.scan_pairs(
        tt, _t(tokens), _t(lengths),
        None if state is None else tscan.from_numpy_u32(state, CPU),
        None if match is None else tscan.from_numpy_u32(match, CPU))
    assert torch.equal(m, wm) and torch.equal(s, ws)
    jm, js = jscan.scan_pairs_jit(jt, tokens, lengths, state, match)
    sc = PallasByteScanner(jt, TB=8, CL=16, MR=8)
    rm, rs = sc(tokens, lengths, state, match, mode="reference")
    km, _ = sc(tokens, lengths, state, match, interpret=True)
    for got, want in ((m, jm), (s, js), (m, rm), (s, rs), (m, km)):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert (_u32(m)[:, 0] >> 31).any()


@pytest.mark.parametrize("G", [32, 96, 128])
def test_torch_split_short_halo_loses_a_match(halo_packs, G):
    """A halo one pair short (15 pairs) misses the 32-byte factor that
    ends on a segment's first byte, so the exactness tests above would
    catch a short halo.  The per-byte step needs 31 bytes, not 32: its
    first recorded state already includes the segment's first byte, so
    31 bytes stay exact and 30 lose the same match."""
    jt, tt = halo_packs
    tokens, lengths, state, match = _boundary_rows(G, G, tt.n_words)
    whole_m, _ = jscan.scan_bytes_jit(jt, tokens, lengths, state, match)
    whole_m = np.asarray(whole_m)

    def split(halo, pairs):
        m, _ = _split_twin(tt, tokens, lengths, state, match, G, halo,
                           pairs)
        return _u32(m)

    assert not np.array_equal(split(30, True), whole_m)
    assert not np.array_equal(split(30, False), whole_m)
    np.testing.assert_array_equal(split(31, False), whole_m)
    np.testing.assert_array_equal(split(32, True), whole_m)


PLAN_SHAPES = [(1024, 64), (16, 64), (512, 128), (32, 128), (256, 256),
               (128, 256), (8, 512), (8, 2048), (16, 2048), (32, 2048),
               (8, 16384), (1024, 2048), (1024, 16384), (1001, 333),
               (1, 1 << 20), (4096, 4096), (3, 0)]


@pytest.mark.parametrize("B,L", PLAN_SHAPES)
def test_torch_segment_plan_properties(B, L):
    """G is a multiple of 32; a split has segments of at least
    MIN_SEGMENT and at least MIN_SPLIT of them; the segments cover the
    row; the grid holds every unit."""
    from ingress_plus_tpu_torch.ops import segments as seg

    plan = seg.plan_segments(B, L, 225)
    assert plan.G % 32 == 0
    assert plan.segments == max(1, -(-L // plan.G))
    if plan.segments > 1:
        assert plan.G >= seg.MIN_SEGMENT
        assert plan.segments >= seg.MIN_SPLIT
    else:
        assert plan.G >= L
    assert plan.grid == (8, -(-B * plan.segments // 8))
    assert plan.grid[1] <= seg.MAX_GRID_Y
    if (B, L) in ((1024, 2048), (1024, 16384)):   # the card is full
        assert plan.segments == 1
    if (B, L) in ((8, 2048), (8, 16384)):         # row-starved
        assert plan.segments > 1


def test_torch_segment_plan_forced_and_refused():
    """A forced length splits exactly as asked; L or more is one
    segment; a split length off the 32-byte grid and a grid overflow are
    refused."""
    from ingress_plus_tpu_torch.ops import segments as seg

    assert seg.plan_segments(8, 2048, 225, segment=256)[:2] == (256, 8)
    assert seg.plan_segments(8, 2048, 225, segment=2048)[:2] == (2048, 1)
    assert seg.plan_segments(8, 333, 225, segment=333)[:2] == (352, 1)
    for bad in (48, 16):
        with pytest.raises(ValueError, match="multiple of 32"):
            seg.plan_segments(8, 2048, 225, segment=bad)
    with pytest.raises(ValueError, match="grid"):
        seg.plan_segments(8 * 65535 + 1, 64, 225)


def test_torch_tile_class_table(packs):
    """The kernels' word-tile-major class table: tile t, class c, lane l
    holds class c's word 32*t + l, zero past W."""
    from ingress_plus_tpu_torch.ops.cuda_build import tile_class_table

    _, tt = packs
    ct = tt.class_table
    tiles = tile_class_table(ct)
    K1, W = ct.shape
    assert tiles.shape == (-(-W // 32), K1, 32) and tiles.is_contiguous()
    flat = tiles.permute(1, 0, 2).reshape(K1, -1)
    assert torch.equal(flat[:, :W], ct)
    assert not flat[:, W:].any()
