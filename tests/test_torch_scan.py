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
