"""Converted weights (``--pretrained_root``) and the CLIP tokenizer against
the JAX package on the CPU.

Tiny SD and zero123 towers' params written with JAX's ``save_params_npz``
into a temp dir are read by both packages' ``load_pretrained`` (JAX's init
replaced by a template of random params: its eager Flax init takes a
minute on the CPU); the port's towers then hold JAX's loaded params bit for
bit.  A key the file lacks keeps the init, a shape that does not fit
raises, and a root without npz files goes to the raw conversion.  The
port's plain-Python CLIP BPE against ``transformers.CLIPTokenizer`` (JAX's
``load_tokenizer``) on a toy ``vocab.json`` and ``merges.txt``, and the
hash tokenizer where the files are missing.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance import embeddings as jemb
from dreamfusion_tpu.guidance import zero123 as jz
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig
from dreamfusion_tpu.guidance.sd import StableDiffusionGuidance as JSD
from dreamfusion_tpu.utils.params import save_params_npz
from dreamfusion_tpu_torch.guidance import embeddings as pemb
from dreamfusion_tpu_torch.guidance import zero123 as pz
from dreamfusion_tpu_torch.guidance.sd import SDConfig, StableDiffusionGuidance
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import random_flax_params

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TINY_SD = dict(tiny=True, image_size=16, latent_size=8)


def _sd_params(jg, seed):
    z = jnp.zeros
    return jax.tree.map(np.asarray, {
        "unet": random_flax_params(jg.unet.init, z((1, 8, 8, 4)), z((1,)),
                                   z((1, 16, 32)), seed=seed),
        "vae": random_flax_params(jg.vae.init, z((1, 16, 16, 3)),
                                  jax.random.PRNGKey(1), seed=seed + 1),
        "text": random_flax_params(jg.text_encoder.init,
                                   z((1, 16), jnp.int32), seed=seed + 2)})


def _zero123_params(jg, seed):
    z = jnp.zeros
    rng = np.random.default_rng(seed)
    return jax.tree.map(np.asarray, {
        "unet": random_flax_params(jg.unet.init, z((1, 8, 8, 8)), z((1,)),
                                   z((1, 1, 32)), seed=seed),
        "vae": random_flax_params(jg.vae.init, z((1, 16, 16, 3)),
                                  jax.random.PRNGKey(1), seed=seed + 1),
        "vision": random_flax_params(jg.vision.init, z((1, 32, 32, 3)),
                                     seed=seed + 2),
        "cc_projection": {
            "kernel": rng.standard_normal((36, 32)).astype(np.float32),
            "bias": rng.standard_normal(32).astype(np.float32)}})


def _pair(kind):
    """(JAX guidance, the port's, its towers) of a tiny SD or zero123."""
    if kind == "SD":
        return (JSD(JSDConfig(**TINY_SD)),
                StableDiffusionGuidance(SDConfig(**TINY_SD), "cpu"))
    return (jz.Zero123Guidance(jz.Zero123Config(tiny=True)),
            pz.Zero123Guidance(pz.Zero123Config(tiny=True), "cpu"))


def _params(kind, jg, seed):
    return _sd_params(jg, seed) if kind == "SD" else \
        _zero123_params(jg, seed)


def _drop(tree, path):
    """`tree` without the leaf at the '/'-joined `path`."""
    out = dict(tree)
    head, _, rest = path.partition("/")
    out[head] = _drop(tree[head], rest) if rest else None
    if out[head] is None or out[head] == {}:
        del out[head]
    return out


@pytest.mark.parametrize("kind", ["SD", "zero123"])
def test_load_pretrained_matches_jax(tmp_path, monkeypatch, kind):
    """Every tower's npz read by both packages: the port's state_dicts are
    JAX's loaded params, converted, bit for bit; a key missing from the
    UNet's file keeps each package's init."""
    jg, pg = _pair(kind)
    template, saved = _params(kind, jg, 1), _params(kind, jg, 5)
    missing = "conv_out/bias"
    for name, tree in saved.items():
        save_params_npz(str(tmp_path / f"{name}.npz"),
                        _drop(tree, missing) if name == "unet" else tree)
    monkeypatch.setattr(jg, "init_params", lambda key, dtype=None: template)
    jp = jg.load_pretrained(str(tmp_path))
    gen = torch.Generator().manual_seed(0)
    pg.init_params(torch.Generator().manual_seed(0))
    init_bias = pg.unet.conv_out.bias.detach().clone()
    pg.load_pretrained(str(tmp_path), gen)
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    towers = pg.towers()
    assert set(want) == set(towers)
    for name, sd in want.items():
        got = towers[name].state_dict()
        assert set(got) == set(sd), name
        for k, v in sd.items():
            if name == "unet" and k == "conv_out.bias":
                np.testing.assert_array_equal(
                    v.numpy(), template["unet"]["conv_out"]["bias"])
                torch.testing.assert_close(got[k], init_bias, rtol=0, atol=0)
                continue
            np.testing.assert_array_equal(got[k].float().numpy(), v.numpy(),
                                          err_msg=f"{name}.{k}")


@pytest.mark.parametrize("kind", ["SD", "zero123"])
def test_load_pretrained_refuses_a_shape_that_does_not_fit(tmp_path, kind):
    jg, pg = _pair(kind)
    saved = _params(kind, jg, 2)
    vae = saved["vae"]
    vae["encoder"]["quant_conv"]["bias"] = np.zeros(5, np.float32)
    save_params_npz(str(tmp_path / "vae.npz"), vae)
    with pytest.raises(ValueError, match="encoder/quant_conv/bias"):
        pg.load_pretrained(str(tmp_path), torch.Generator().manual_seed(0))


def _queue1_titles():
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text.split("### Queue 1")[1].split("### Queue 2")[0]
    return [t.replace("`", "").rstrip(".") for t in
            re.findall(r"^\d+\. \*\*(.+?)\*\*", queue, re.M)]


@pytest.mark.parametrize("kind", ["SD", "zero123"])
def test_a_root_without_npz_names_raw_checkpoint_conversion(tmp_path,
                                                            kind):
    """A root without npz files is a raw checkpoint, converted on the fly
    as JAX does (``utils/raw_weights.py``; tests/test_torch_convert_raw.py
    holds the conversions): here a diffusers directory whose unet/ holds no
    weights, which SD's conversion reports, and a directory, where
    zero123's wants one .ckpt file."""
    (tmp_path / "unet").mkdir()
    (tmp_path / "model_index.json").write_text("{}")
    _, pg = _pair(kind)
    with pytest.raises(FileNotFoundError) as e:
        pg.load_pretrained(str(tmp_path), torch.Generator().manual_seed(0))
    assert ("no weights under" if kind == "SD" else ".ckpt") in str(e.value)
    assert "Raw checkpoint conversion" not in _queue1_titles()


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------

MERGES = ["h a", "ha m", "b u", "r g", "e r</w>", "bu rg", "ham burg",
          "hamburg er</w>", "a</w>", "o f</w>", "p h", "ph o", "pho t",
          "phot o</w>", "v i", "vi e", "vie w</w>", "f r", "fr o", "fro n",
          "fron t</w>", "c o", "co r", "cor g", "corg i</w>", "d o",
          "do n</w>", "' t</w>", "c a", "ca f", "caf é</w>", "1</w>",
          "t h", "th e</w>", "s i", "si d", "sid e</w>"]


def _toy_tokenizer_files(root):
    """A vocab of every byte character with and without ``</w>``, the
    merges above and the two special tokens."""
    chars = list(pemb.bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars]
    for m in MERGES:
        vocab.append(m.replace(" ", ""))
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (root / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(dict.fromkeys(vocab))},
        ensure_ascii=False), encoding="utf-8")
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(MERGES) + "\n", encoding="utf-8")


TEXTS = ["a hamburger", "A DSLR photo of a Corgi, front view",
         "a hamburger, side view", "don't stop", "Café   1999\tthe\nend",
         "naïve façade 東京 🙂 x", "", "a <|endoftext|> b",
         "the " * 40 + "end"]


@pytest.mark.parametrize("max_len", [77, 16])
def test_bpe_tokenizer_matches_transformers(tmp_path, max_len):
    """JAX's ``load_tokenizer`` (``transformers.CLIPTokenizer`` from the
    root) and the port's give the same ids: lower case, contractions,
    digits one by one, accents kept, CJK split, emoji bytes, whitespace
    runs, truncation and padding to max_len."""
    _toy_tokenizer_files(tmp_path)
    jtok = jemb.load_tokenizer(str(tmp_path), 49408, max_len)
    ptok = pemb.load_tokenizer(str(tmp_path), 49408, max_len)
    assert isinstance(ptok, pemb.CLIPBPETokenizer)
    assert not isinstance(jtok, jemb.HashTokenizer)
    for text in TEXTS:
        got, want = ptok(text), jtok(text)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=repr(text))
    ids = ptok("a hamburger")[0]
    vocab = json.loads((tmp_path / "vocab.json").read_text("utf-8"))
    assert ids[1] == vocab["a</w>"] and ids[2] == vocab["hamburger</w>"]


def test_tokenizer_falls_back_to_the_hash_tokenizer(tmp_path):
    """Without vocab.json and merges.txt (or without a root), the hash
    tokenizer, as JAX's rule."""
    (tmp_path / "vocab.json").write_text("{}")
    for root in (None, str(tmp_path), str(tmp_path / "absent")):
        ptok = pemb.load_tokenizer(root, 300, 16)
        jtok = jemb.load_tokenizer(root, 300, 16)
        assert isinstance(ptok, pemb.HashTokenizer)
        assert isinstance(jtok, jemb.HashTokenizer)
        np.testing.assert_array_equal(ptok("a hamburger, front view"),
                                      jtok("a hamburger, front view"))


def test_pre_tokenizer_matches_clips_pattern():
    """The pattern's alternatives in order, on a string that exercises
    each (transformers' compiled ``regex`` pattern as the reference)."""
    import regex
    pat = regex.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|"""
                        r"""'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|"""
                        r"""[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
    for text in ["it's 2024!! we're here'd ''x", "<|ENDOFTEXT|>a<|startoftext|>",
                 "ab12cd ... --> émile", "東京タワー ½ ²"]:
        assert pemb.pre_tokenize(text) == pat.findall(text), text
