"""scripts/torch_k9_variants.py's text patches still apply to the kernel
sources (ROADMAP G4): a patch whose text a source no longer holds made a
default run raise before it timed anything."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_k9_variants", ROOT / "scripts" / "torch_k9_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


V = _script()


@pytest.mark.parametrize("name", sorted(V.VARIANTS))
def test_variant_patches_apply(name):
    base = V.patched_sources("base")
    got = V.patched_sources(name)
    assert set(got) == set(base)
    for fname, old, new in V.VARIANTS[name]:
        assert got[fname].count(new) >= 1, (fname, new)
        assert got[fname] != base[fname]
    assert V.K9 in got


def test_a_patch_that_does_not_apply_raises(monkeypatch):
    monkeypatch.setitem(V.VARIANTS, "stale", [(V.MMA, "no such text", "x")])
    with pytest.raises(RuntimeError, match="does not apply"):
        V.patched_sources("stale")
