"""The port's pretrained audio weights (``msmd_tpu_torch/hf_loader.py``)
against the JAX package's loader (``msmd_tpu/interop/hf_loader.py``) on the
CPU: one tiny HF wav2vec2 directory written by ``transformers``'
``save_pretrained`` as ``model.safetensors`` and as ``pytorch_model.bin``,
and the same files in the HF cache layout
(``models--org--name/snapshots/<rev>``) and with a task model's
``hubert.`` prefix (written by the port's own safetensors writer):

- each goes through JAX's ``inject_pretrained_audio`` and the port's; the
  two encoders' outputs on the same audio agree to 1e-5 of max |out|, and
  the port's parameters equal the JAX tree's and the file's tensors
  exactly (the positional convolution's weight-norm pair is folded the
  same way on both sides);
- the port's safetensors reader and writer against the ``safetensors``
  package, both ways, bit for bit (f32, bf16, int64, bool);
- a shape that does not fit raises with the parameter's name; a name
  that resolves to no directory raises ``FileNotFoundError``.
"""

import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util
from torch import nn

from msmd_tpu_torch.config import AudioEncoderConfig
from msmd_tpu_torch.hf_loader import (inject_pretrained_audio, load_state_dict_file, read_safetensors,
                                      resolve_model_dir, write_safetensors)
from msmd_tpu_torch.interop import flax_tree
from msmd_tpu_torch.models.audio import AudioEncoder

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, conv_dim=(16, 16, 16),
            conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


class _Holder(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.audio_encoder = AudioEncoder(AudioEncoderConfig(**{**TINY, **kw}))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{layout: (path, cache_dir)} of one seeded HF model, and its state dict."""
    from transformers import Wav2Vec2Config, Wav2Vec2Model

    torch.manual_seed(0)
    hf = Wav2Vec2Model(Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=[16, 16, 16], conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2],
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, feat_extract_norm="group",
        do_stable_layer_norm=False, hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
        layerdrop=0.0)).eval()
    root = tmp_path_factory.mktemp("hf")
    hf.save_pretrained(root / "st")
    hf.save_pretrained(root / "bin", safe_serialization=False)
    snap = root / "cache" / "models--org--tiny-w2v" / "snapshots" / "0123abcd"
    shutil.copytree(root / "st", snap)
    (root / "prefixed").mkdir()
    shutil.copy(root / "st" / "config.json", root / "prefixed" / "config.json")
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    write_safetensors(root / "prefixed" / "model.safetensors", {f"hubert.{k}": v for k, v in sd.items()})
    assert (root / "st" / "model.safetensors").exists() and (root / "bin" / "pytorch_model.bin").exists()
    layouts = {"safetensors": (str(root / "st"), None), "bin": (str(root / "bin"), None),
               "cache": ("org/tiny-w2v", str(root / "cache")), "prefixed": (str(root / "prefixed"), None)}
    return layouts, {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("layout", ["safetensors", "bin", "cache", "prefixed"])
def test_port_and_jax_inject_the_same_encoder(sources, layout):
    from msmd_tpu.interop.hf_loader import inject_pretrained_audio as jinject
    from msmd_tpu.models.audio import AudioEncoder as JEnc, AudioEncoderConfig as JCfg

    layouts, sd = sources
    path, cache = layouts[layout]  # JAX reads the port-written prefixed file through the safetensors package
    jenc = JEnc(JCfg(**TINY))
    init = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 2000)), frame_num=None)["params"]
    jtree = jinject({"audio_encoder": init}, path, cache)["audio_encoder"]
    holder = _Holder()
    inject_pretrained_audio(holder, path, cache)

    want = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, jtree))
    got = traverse_util.flatten_dict(flax_tree(holder.audio_encoder))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=str(k))
    enc = holder.audio_encoder
    np.testing.assert_array_equal(enc.encoder.layers[1].q_proj.weight.detach().numpy(),
                                  sd["encoder.layers.1.attention.q_proj.weight"])
    np.testing.assert_array_equal(enc.feature_extractor.conv[0].weight.detach().numpy(),
                                  sd["feature_extractor.conv_layers.0.conv.weight"])
    np.testing.assert_array_equal(enc.masked_spec_embed.detach().numpy(), sd["masked_spec_embed"])

    audio = np.random.RandomState(0).randn(2, 2000).astype(np.float32)
    jout = np.asarray(jenc.apply({"params": jtree}, jnp.asarray(audio), frame_num=None))
    with torch.no_grad():
        out = enc(torch.from_numpy(audio), frame_num=None).numpy()
    assert out.shape == jout.shape
    assert np.abs(out - jout).max() <= 1e-5 * np.abs(jout).max()


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(3)
    tensors = {"a": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3), "d": torch.tensor([True, False, True]),
               "e": torch.zeros(0, 4)}
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    write_safetensors(tmp_path / "port.safetensors", tensors)
    for read in (read_safetensors(tmp_path / "lib.safetensors"), load_file(str(tmp_path / "port.safetensors"))):
        assert set(read) == set(tensors)
        for k, v in tensors.items():
            assert read[k].dtype == v.dtype and torch.equal(read[k], v), k
    wide = load_state_dict_file(tmp_path / "port.safetensors")
    assert wide["b"].dtype == np.float32 and np.array_equal(wide["b"], tensors["b"].float().numpy())


def test_shape_mismatch_names_the_parameter(sources):
    layouts, _ = sources
    with pytest.raises(ValueError, match=r"audio_encoder\.feature_projection\.projection\.weight"):
        inject_pretrained_audio(_Holder(hidden_size=48, num_heads=4, num_conv_pos_embedding_groups=4),
                                layouts["safetensors"][0])


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="does-not-exist-locally"):
        resolve_model_dir("facebook/does-not-exist-locally", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="No weight file"):
        inject_pretrained_audio(_Holder(), str(tmp_path))
