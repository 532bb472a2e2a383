"""``examples/layout_ab.py`` builds each layout alternative from its kernel's
source by one substitution; on the CPU, check that each still matches the
source it edits and changes it (the timing itself needs a card)."""
import os

import pytest
import torch

from cwbnwp_letkf_torch.examples import layout_ab
from cwbnwp_letkf_torch.ops import cuda_build


@pytest.mark.parametrize("name", sorted(layout_ab.VARIANTS))
def test_variant_is_one_substitution_of_its_source(name):
    src, old, new = layout_ab.VARIANTS[name]
    text = (cuda_build.CSRC / src).read_text()
    out = layout_ab.variant_source(name)
    assert text.count(old) == 1 and out != text
    assert out == text.replace(old, new)


def test_variant_that_no_longer_matches_raises(monkeypatch):
    monkeypatch.setitem(layout_ab.VARIANTS, "stale",
                        ("ns_invsqrt.cu", "no such line\n", ""))
    with pytest.raises(ValueError, match="occurs 0 times"):
        layout_ab.variant_source("stale")


def test_raises_without_card(tmp_path, monkeypatch):
    """Without a card it raises before it builds or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layout_ab.main(["--out", str(tmp_path / "ab.json")])
    assert os.listdir(tmp_path) == []
