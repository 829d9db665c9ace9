"""Identity pins for every jit-factory memo in the engine.

The round-4 final commit (205af23) refactored _jit_feat_builder to
delegate to a helper and moved the lru_cache onto the helper, whose
memo was keyed on a closure built fresh every call — so the cache
never hit, every prepare() recompiled the feature builder, and the
helper's unbounded cache retained every compiled executable (the
deterministic full-suite segfault the round-4 judge isolated).

These tests make that class of failure impossible to ship silently:
for every jit factory, calling twice with identical arguments MUST
return the very same object (`is`), which is what makes XLA reuse the
compiled executable instead of retracing.
"""

import pytest

from distance_tpu import engine


FACTORIES = [
    # (factory, args) — args must be representative hot-path keys
    (engine._jit_block_fn, ("raw", 64, 64)),
    (engine._jit_block_fn, ("tn93", 64, 64, "rel4", 29904)),
    (engine._jit_feat_builder, ("raw", "g")),
    (engine._jit_feat_builder, ("raw", "f", False)),
    (engine._jit_feat_builder, ("tn93", "g", False)),
    (engine._jit_fx_strip, ("raw", 64)),
    (engine._jit_fx_slice, ("raw", 64)),
    (engine._jit_block_fn_feat, ("raw", 64, 64)),
    (engine._jit_block_fn_feat, ("k80", 64, 64, "rel4", 29904)),
    (engine._jit_stream_fn,
     ("raw", 64, 8, 64, "none", 0, 128, None, False)),
]


@pytest.mark.parametrize(
    "factory,args", FACTORIES,
    ids=lambda v: getattr(v, "__name__", None) or repr(v),
)
def test_factory_returns_identical_object(factory, args):
    assert factory(*args) is factory(*args), (
        f"{factory.__name__}{args} built a fresh jitted fn on the "
        "second identical call — its memo is broken (recompile per "
        "prepare + unbounded executable leak; see 205af23)"
    )


def test_feat_builder_blocked_identity():
    # needs a devices() call at trace time; key-level identity is what
    # matters and must hold without executing the fn
    f1 = engine._jit_feat_builder_blocked("raw", 64)
    f2 = engine._jit_feat_builder_blocked("raw", 64)
    assert f1 is f2


def test_replicated3_not_closure_memoized():
    """_jit_replicated3 must NOT carry a closure-keyed lru_cache: its
    callers are the memo layer.  A cache here would silently leak one
    entry per fresh closure (the 205af23 failure shape)."""
    assert not hasattr(engine._jit_replicated3, "cache_info")
