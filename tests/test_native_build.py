"""The native library is keyed on source, flags and host CPU: a library
built elsewhere or from other source is never loaded."""

import shutil

import distance_tpu._native as native


def _fresh_loader(monkeypatch, tmp_path):
    """Point the loader at a private copy of native.c with no library
    built yet, and record builds instead of compiling."""
    src = tmp_path / "native.c"
    shutil.copy(native._SRC, src)
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("DISTANCE_TPU_NO_NATIVE", raising=False)
    built = []

    def fake_build(so):
        built.append(so)
        return False

    monkeypatch.setattr(native, "_build", fake_build)
    return src, built


def test_rebuilds_when_build_key_differs(monkeypatch, tmp_path):
    src, built = _fresh_loader(monkeypatch, tmp_path)
    # a library from another host sits under the old name and under
    # that host's key: neither is loaded
    (tmp_path / "libdistance_native.so").write_bytes(b"stale")
    monkeypatch.setattr(native, "_host_cpu", lambda: "other host")
    (tmp_path / f"libdistance_native.{native._build_key()}.so").write_bytes(
        b"stale"
    )
    monkeypatch.setattr(native, "_host_cpu", lambda: "this host")
    assert native.get_lib() is None
    assert built == [str(tmp_path / f"libdistance_native.{native._build_key()}.so")]
    assert "other" not in built[0]


def test_build_key_covers_source_flags_and_cpu(monkeypatch, tmp_path):
    src, _built = _fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "_host_cpu", lambda: "cpu A")
    key = native._build_key()
    assert native._build_key() == key  # stable
    monkeypatch.setattr(native, "_host_cpu", lambda: "cpu B")
    assert native._build_key() != key
    monkeypatch.setattr(native, "_host_cpu", lambda: "cpu A")
    src.write_bytes(src.read_bytes() + b"\n/* edit */\n")
    assert native._build_key() != key
    src.write_bytes(src.read_bytes()[: -len(b"\n/* edit */\n")])
    assert native._build_key() == key
    monkeypatch.setenv("CC", "some-other-cc")
    assert native._build_key() != key


def test_host_cpu_names_this_machine():
    assert native._host_cpu()
