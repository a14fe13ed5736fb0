"""tools/torch_walk_variants.py carries its design variants as text edits
of the tree's csrc/ (a variant is built from a copy with its edits
applied). Each edit has to find its text in the tree's sources, or the
variant fails to build on the card; this checks that here, without nvcc.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_walk_variants as tv  # noqa: E402

CSRC = os.path.join(ROOT, "gpupathtracer_tpu_torch", "csrc")


def test_every_variant_edit_finds_its_text_in_the_tree():
    missing = []
    for name, (_, sources, edits) in tv.VARIANTS.items():
        assert sources and set(sources) <= set(tv.CHECKOUT_SOURCES), name
        for f, reps in edits.items():
            text = open(os.path.join(CSRC, f)).read()
            for old, new in reps:
                if old not in text:
                    missing.append((name, f, old[:60]))
                text = text.replace(old, new)
            if name.startswith("node-"):
                # the C entry and the kernel the node-probe group times
                assert "int gpt_roofline_node_slab(" in text, name
                assert "node_slab_kernel(" in text, name
    assert not missing, missing
