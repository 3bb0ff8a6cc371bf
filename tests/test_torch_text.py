"""Port: the tokenizer copy, the CLIP text tower and the query bank against
the JAX package's.

The tokenizers' ids, masks and prompts are equal (HashTokenizer, and the
CLIP BPE on a small vocab). `text.forward` and `build_query_bank` run on
the JAX init tree carried across by `from_jax_tree`, in fp32, with padded
prompts (so the padding bias and EOT pooling matter): atol 1e-5, the two
sides' float32 summation orders through a 2-layer tower.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlvit_tpu.data import tokenizer as jtok
from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.models import text as jtext
from owlvit_tpu_torch.data import tokenizer
from owlvit_tpu_torch.models import get_config, owlvit, text
from owlvit_tpu_torch.models.convert import from_jax_tree

ATOL = 1e-5
LABELMAP = {0: "red square", 1: "green ellipse", 2: "blue triangle", 3: "cat"}


@pytest.fixture(scope="module")
def trees():
    cfg = jax_get_config("tiny")
    tree = jax.tree.map(np.asarray, jowlvit.init(jax.random.PRNGKey(4), cfg, num_queries=12))
    model, skipped = from_jax_tree(tree, get_config("tiny"))
    assert skipped == []
    return tree, model.eval()


def _ids(max_len=16, vocab=128):
    enc = tokenizer.HashTokenizer(vocab, max_len=max_len)(tokenizer.build_prompts(LABELMAP))
    return enc["input_ids"], enc["attention_mask"]


def test_prompts_equal():
    assert tokenizer.build_prompts(LABELMAP) == jtok.build_prompts(LABELMAP)
    assert tokenizer.prompt_templates("dog") == jtok.prompt_templates("dog")


@pytest.mark.parametrize("vocab,max_len", [(128, 16), (49408, 16), (128, 4)])
def test_hash_tokenizer_equal(vocab, max_len):
    """max_len 4 truncates the longer prompts (EOT kept last)."""
    texts = jtok.build_prompts(LABELMAP) + ["  A   Photo  ", "x"]
    got = tokenizer.HashTokenizer(vocab, max_len=max_len)(texts)
    want = jtok.HashTokenizer(vocab, max_len=max_len)(texts)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_clip_tokenizer_equal(tmp_path):
    chars = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'- "
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    merges = [("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"), ("o", "f</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vf, mf = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vf.write_text(json.dumps(vocab))
    mf.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    texts = ["a photo of the cat", "The CAT's dog, thinking?"]
    got = tokenizer.CLIPTokenizer(str(vf), str(mf), max_len=12)(texts)
    want = jtok.CLIPTokenizer(str(vf), str(mf), max_len=12)(texts)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k])


def test_text_forward_matches_jax(trees):
    tree, model = trees
    ids, mask = _ids()
    assert (mask == 0).any()  # padded prompts
    want = jtext.forward(tree["text"], jax_get_config("tiny").text, jnp.asarray(ids),
                         jnp.asarray(mask))
    with torch.no_grad():
        got = text.forward(model.text, get_config("tiny").text, torch.from_numpy(ids),
                           torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_text_forward_without_mask_matches_jax(trees):
    tree, model = trees
    ids, _ = _ids(max_len=8)
    want = jtext.forward(tree["text"], jax_get_config("tiny").text, jnp.asarray(ids))
    with torch.no_grad():
        got = text.forward(model.text, get_config("tiny").text, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_query_bank_matches_jax(trees):
    tree, model = trees
    ids, mask = _ids()
    want = jowlvit.build_query_bank(tree, jax_get_config("tiny"), jnp.asarray(ids),
                                    jnp.asarray(mask))
    with torch.no_grad():
        got = owlvit.build_query_bank(model, get_config("tiny"), torch.from_numpy(ids),
                                      torch.from_numpy(mask))
    assert got.shape == (3 * len(LABELMAP), get_config("tiny").projection_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


def test_text_tower_carried_by_the_bridge(trees):
    tree, model = trees
    sd = model.state_dict()
    t = tree["text"]
    np.testing.assert_array_equal(sd["text.token_embedding"].numpy(), t["token_embedding"])
    np.testing.assert_array_equal(sd["text.projection.weight"].numpy(),
                                  t["projection"]["kernel"].T)
    np.testing.assert_array_equal(sd["text.layers.1.attn.k.weight"].numpy(),
                                  t["layers"]["attn"]["k"]["kernel"][1].T)
    np.testing.assert_array_equal(sd["text.final_ln.weight"].numpy(), t["final_ln"]["scale"])


def test_biased_attention_matches_jax(trees):
    """One encoder block's attention with the causal and padding masks
    against the JAX package's XLA attention (causal=True, bias)."""
    from owlvit_tpu.models import layers as jlayers

    tree, model = trees
    ids, mask = _ids(max_len=8)
    x = np.random.default_rng(2).normal(size=(*ids.shape, 32)).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], tree["text"]["layers"]["attn"])
    bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    want = jlayers.attention(p0, jnp.asarray(x), 4, bias=jnp.asarray(bias), causal=True)
    S = ids.shape[1]
    causal = np.where(np.tril(np.ones((S, S), bool)), 0.0,
                      np.finfo(np.float32).min).astype(np.float32)
    with torch.no_grad():
        got = model.text.layers[0].attn(torch.from_numpy(x),
                                        bias=torch.from_numpy(causal + bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
