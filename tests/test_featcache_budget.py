"""Feature-cache engagement must respect the HBM budget, not just
FEATCACHE_BUDGET.

Regression for a device OOM: at 20000 x 29904, measure ``n``
(14 channels), a g-cache tensor just under the featcache budget
engaged, and cache + codes + builder temporaries exhausted device
memory (``RESOURCE_EXHAUSTED`` at ``engine.prepare``).  Engagement now
requires ``cache + codes <= HBM_BUDGET_BYTES`` as well, and the in-core
gates compare the PREPARED footprint (padded codes + engaged cache)
against the budget instead of raw source bytes.
"""

import io

import numpy as np
import pytest

import distance_tpu.engine as engine
from distance_tpu.encoding import ALL_CODES
from distance_tpu.fastaio import load_fastas
from distance_tpu.writer import TsvWriter


def _mat(n=32, width=256, seed=0):
    rng = np.random.default_rng(seed)
    return rng.choice(ALL_CODES, size=(n, width)).astype(np.uint8)


def _footprints(n, width, measure, ti):
    """(mat_bytes, cache_bytes) as prepare() computes them."""
    from distance_tpu.ops.features import get_plan

    n_pad = -(-n // ti) * ti
    l_pad = -(-width // 128) * 128
    mat = n_pad * l_pad
    return mat, get_plan(measure).total_channels * n_pad * l_pad


@pytest.mark.parametrize("measure", ["n", "raw"])
def test_gcache_respects_hbm_budget(monkeypatch, measure):
    n, width, ti = 32, 256, 32
    mat_b, cache_b = _footprints(n, width, measure, ti)
    eng = engine._BlockEngine(measure, "xla", ti, ti, width)

    # budget admits the cache: engaged
    monkeypatch.setattr(engine, "HBM_BUDGET_BYTES", cache_b + mat_b)
    dev = eng.prepare(_mat(n, width), ti)
    assert eng.gfeat_of(dev) is not None
    eng.release(dev)

    # one byte short: cache must NOT engage (this is the OOM guard)
    monkeypatch.setattr(engine, "HBM_BUDGET_BYTES", cache_b + mat_b - 1)
    dev = eng.prepare(_mat(n, width, seed=1), ti)
    assert eng.gfeat_of(dev) is None
    eng.release(dev)


def test_fcache_respects_hbm_budget(monkeypatch):
    n, width, ti = 32, 256, 32
    mat_b, cache_b = _footprints(n, width, "raw", ti)
    eng = engine._BlockEngine("raw", "xla", ti, ti, width)

    # g engages too (cache_g defaults True), so f needs 2*cache + mat
    monkeypatch.setattr(engine, "HBM_BUDGET_BYTES", 2 * cache_b + mat_b)
    dev = eng.prepare(_mat(n, width), ti, cache_f=True)
    assert eng._fcache.get(id(dev)) is not None
    eng.release(dev)

    monkeypatch.setattr(
        engine, "HBM_BUDGET_BYTES", 2 * cache_b + mat_b - 1
    )
    dev = eng.prepare(_mat(n, width, seed=1), ti, cache_f=True)
    assert eng._fcache.get(id(dev)) is None
    eng.release(dev)


def _run_square(measure, fasta, backend="xla"):
    loaded = load_fastas([io.BytesIO(fasta)])
    loaded[0].count_bases()
    out = io.BytesIO()
    setup = engine.Setup(
        loaded=loaded, streamed=None, writer=TsvWriter(out),
        measure=measure, n_threads=1, batchsize=1, backend=backend,
        tile_i=16, tile_j=16,
    )
    engine.run(setup)
    return out.getvalue()


def test_incore_sweep_with_cache_disabled_matches_numpy(monkeypatch):
    """Budget between codes and codes+cache: the sweep stays in-core,
    the cache silently disables, bytes match the numpy oracle."""
    from distance_tpu.encoding import CODE_TO_CHAR

    rng = np.random.default_rng(7)
    mat = rng.choice(ALL_CODES, size=(40, 300)).astype(np.uint8)
    fasta = b"".join(
        b">s%d\n%s\n" % (i, "".join(CODE_TO_CHAR[c] for c in r).encode())
        for i, r in enumerate(mat)
    )
    mat_b, cache_b = _footprints(40, 300, "n", 16)
    # admits padded codes but not codes + cache
    monkeypatch.setattr(engine, "HBM_BUDGET_BYTES", cache_b + mat_b - 1)
    got = _run_square("n", fasta)
    want = _run_square("n", fasta, backend="numpy")
    assert got == want


@pytest.mark.parametrize(
    "n,ti,max_block", [(40, 16, 16), (40, 16, 48), (100, 16, 64),
                       (64, 32, 32), (7, 16, 128)]
)
def test_footprint_models_prepare_padding_exactly(n, ti, max_block):
    """_prepared_footprint's n_pad must replay prepare()'s formula —
    the rectangle gate under-counted file2 by modeling a tj row stride
    while prepare pads with the ENGINE's strip stride ti (self-review
    round-5 finding)."""
    width = 130
    eng = engine._BlockEngine("raw", "xla", ti, max_block, width)
    dev = eng.prepare(_mat(n, width), max_block)
    l_pad = -(-width // 128) * 128
    mat_bytes = dev.shape[0] * dev.shape[1]
    assert dev.shape[1] == l_pad
    got = engine._prepared_footprint(
        n, width, ti, max_block, "raw", "xla", cache_g=False
    )
    assert got == mat_bytes
    eng.release(dev)


def test_staged_memo_accounting_tracks_replacement(monkeypatch):
    """_StagedSide._memo_bytes: a replaced encoding (n_pad change or
    uploader swap invalidates the memo inside prepare) must release the
    stale bytes and count the fresh ones (identity-based accounting)."""
    from distance_tpu.encoding import A as code_A, G as code_G

    rng = np.random.default_rng(3)
    width = 130
    ref = np.full(width, code_A, dtype=np.uint8)
    base = np.tile(ref, (64, 1))
    base[rng.integers(0, 64, 40), rng.integers(0, width, 40)] = code_G
    eng = engine._BlockEngine("raw", "xla", 16, 16, width)
    side = engine._StagedSide(eng, base, 16, ref)
    side.get(0, 32)
    b1 = side._memo_bytes
    assert b1 > 0
    # same span again: device hit, accounting unchanged
    side.get(0, 32)
    assert side._memo_bytes == b1
    # swap the uploader (a stream retarget does this): the memo
    # revalidates, the encoding is REPLACED, bytes must not leak
    ref2 = np.full(width, 72, dtype=np.uint8)  # all 'G'
    side.get(32, 64)
    b2 = side._memo_bytes
    side.diff_ref = ref2
    eng.diff_up = None
    eng._diff_ref_src = None
    side.get(0, 32)
    # the (0,32) memo's old bytes were released and the new encoding
    # (vs the all-G reference: ~width diffs/row) was counted
    assert side._memo_bytes != b2 or side._memos[(0, 32)]["enc"] is not None
    total = 0
    for m in side._memos.values():
        enc = m.get("enc")
        if enc is not None:
            total += enc[0].nbytes + enc[1].nbytes
    assert side._memo_bytes == total


def test_sharded_gcache_accounts_tj_rounded_rows(monkeypatch):
    """Sharded engines build the g cache with _jit_feat_builder_blocked,
    which pads cache rows up to a tj multiple — the engagement predicate
    must budget THOSE rows, not n_pad (an exact-fit engagement at
    ti != tj could otherwise OOM by up to channels x (tj-1) x l_pad)."""
    import jax

    if jax.device_count() < 2:
        pytest.skip("needs the multi-device CPU mesh")
    from distance_tpu.ops.features import get_plan

    n, width, ti, tj = 40, 256, 16, 32
    assert tj % jax.device_count() == 0 or jax.device_count() % 2 == 0
    eng = engine._BlockEngine("raw", "xla", ti, tj, width)
    if not eng.sharded:
        pytest.skip("mesh did not engage for tj=%d" % tj)
    l_pad = -(-width // 128) * 128
    n_pad = (-(-n // ti) - 1) * ti + max(ti, ti)  # prepare(mat, ti)
    assert n_pad % tj != 0, "need a non-tj-multiple n_pad for this test"
    rows_rounded = -(-n_pad // tj) * tj
    r = get_plan("raw").total_channels
    mat_b = n_pad * l_pad
    need_rounded = r * rows_rounded * l_pad
    need_unrounded = r * n_pad * l_pad

    # exact fit of the TRUE (tj-rounded) tensor: engaged, and the cache
    # tensor really does hold rows_rounded rows
    monkeypatch.setattr(engine, "HBM_BUDGET_BYTES", need_rounded + mat_b)
    dev = eng.prepare(_mat(n, width), ti)
    gfeat = eng.gfeat_of(dev)
    assert gfeat is not None
    nb, rr, tjj, ll = gfeat.shape
    assert nb * tjj == rows_rounded and (rr, ll) == (r, l_pad)
    eng.release(dev)

    # the OLD boundary (unrounded rows): must NOT engage — this budget
    # is too small for the real tensor (pre-fix it engaged and OOMed)
    monkeypatch.setattr(
        engine, "HBM_BUDGET_BYTES", need_unrounded + mat_b
    )
    dev = eng.prepare(_mat(n, width, seed=1), ti)
    assert eng.gfeat_of(dev) is None
    eng.release(dev)

    # _prepared_footprint replays the same rounding when given tj
    monkeypatch.setattr(engine, "HBM_BUDGET_BYTES", need_rounded + mat_b)
    got = engine._prepared_footprint(
        n, width, ti, ti, "raw", "xla", tj=tj
    )
    assert got == mat_b + need_rounded


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def fresh_device_budget():
    engine._device_budget.cache_clear()
    yield
    engine._device_budget.cache_clear()


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 60_000_000_000}, 30_000_000_000),
    ({"bytes_limit": 12_000_000_000, "bytes_in_use": 5}, 6_000_000_000),
    (None, engine.FALLBACK_BUDGET_BYTES),
    ({"bytes_in_use": 5}, engine.FALLBACK_BUDGET_BYTES),
])
def test_budgets_derive_from_device_memory(monkeypatch, fresh_device_budget,
                                           stats, want):
    """Both budgets default to DEVICE_BUDGET_SHARE of the device's
    ``bytes_limit``; a device that reports none gets the fallback."""
    import jax

    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(stats)])
    monkeypatch.setattr(engine, "HBM_BUDGET_BYTES", None)
    monkeypatch.setattr(engine, "FEATCACHE_BUDGET", None)
    assert engine._hbm_budget() == want
    assert engine._featcache_budget() == want
    # explicit values (env overrides, tests) win over the device
    monkeypatch.setattr(engine, "HBM_BUDGET_BYTES", 1234)
    monkeypatch.setattr(engine, "FEATCACHE_BUDGET", 0)
    assert engine._hbm_budget() == 1234
    assert engine._featcache_budget() == 0


def test_budgets_fall_back_on_cpu(monkeypatch, fresh_device_budget):
    import jax

    assert jax.devices()[0].memory_stats() is None  # the CPU reports none
    monkeypatch.setattr(engine, "HBM_BUDGET_BYTES", None)
    monkeypatch.setattr(engine, "FEATCACHE_BUDGET", None)
    assert engine._hbm_budget() == engine.FALLBACK_BUDGET_BYTES
    assert engine._featcache_budget() == engine.FALLBACK_BUDGET_BYTES


def test_budget_env_overrides_are_read_at_import():
    import subprocess
    import sys

    code = (
        "import distance_tpu.engine as e;"
        "print(e.HBM_BUDGET_BYTES, e.FEATCACHE_BUDGET, e._hbm_budget())"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, check=True,
        env=dict(__import__("os").environ, JAX_PLATFORMS="cpu",
                 DISTANCE_TPU_HBM_BUDGET="5000",
                 DISTANCE_TPU_FEATCACHE_BUDGET="0"),
        timeout=120,
    )
    assert r.stdout.split() == [b"5000", b"0", b"5000"]
