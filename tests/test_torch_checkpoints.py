"""coral_tpu_torch loads published Hugging Face checkpoints as coral_tpu does.

``transformers`` writes tiny ``Wav2Vec2ForCTC`` and
``WhisperForConditionalGeneration`` checkpoints (``tests/hf_checkpoints.py``:
every tensor drawn by numpy from a seed) as ``model.safetensors`` or
``pytorch_model.bin``, whole or in shards, with the positional conv's weight norm in either key
form; both packages' setups load each directory. Tolerances (fp32 on both
sides, reductions in another order): logits, Whisper's encoder output and its
decode step's logits within 1e-4 of max |JAX| (the JAX package's model-parity
bound); greedy ids, transcripts and frame lengths exactly equal; every loaded
tensor bit for bit the file's after the cast to fp32, the folded positional
conv within 1e-6 of JAX's fold. F16 and BF16 files are held against the
port's own load of an F32 file of the same values, bit for bit (the JAX
package reads no BF16). The golden manifests of facebook/wav2vec2-xls-r-300m
and openai/whisper-large-v3 map at full scale onto the port's models, built
on the meta device and fed zero-stride arrays, so nothing of their size is
allocated.
"""

import importlib.util
import json
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

import hf_checkpoints as hf
from coral_tpu_torch.models import whisper as PW
from coral_tpu_torch.models.convert import (load_torch_state_dict, wav2vec2_state_dict_from_hf,
                                            whisper_state_dict_from_hf)
from coral_tpu_torch.models.safetensors_io import read_safetensors
from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.training import model_setup as port_setup

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

REL_TOL = 1e-4
GOLDEN = Path(__file__).parent / "golden"
W2V2_CASES = [("safetensors", "parametrizations"), ("bin", "parametrizations"),
              ("safetensors", "weight_g"), ("bin", "weight_g")]


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def _batch(seed=0, T=4000, lengths=(4000, 2600, 1700)):
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(lengths), T), np.float32)
    for i, n in enumerate(lengths):
        audio[i, :n] = rng.standard_normal(n) * 0.1
    return {"input_values": audio, "input_lengths": np.asarray(lengths, np.int32)}


def _w2v2_config(directory: Path, model_dir: Path | None = None) -> dict:
    cfg = {"model": {"type": "wav2vec2", "architecture": "tiny",
                     "pretrained_model_id": str(directory), "characters_to_keep": hf.CHARS,
                     "sampling_rate": 16_000},
           "max_seconds_per_example": 5.0, "bf16_allowed": False}
    if model_dir is not None:
        cfg["model_dir"] = str(model_dir)
    return cfg


def _whisper_config(directory: Path, model_dir: Path | None = None) -> dict:
    cfg = {"model": {"type": "whisper", "pretrained_model_id": str(directory),
                     "sampling_rate": 16_000, "language": "danish", "max_length": 16},
           "max_seconds_per_example": 2, "bf16_allowed": False}
    if model_dir is not None:
        cfg["model_dir"] = str(model_dir)
    return cfg


def _jax(config: dict):
    """The JAX setup of ``config``, its params and a one-device mesh's
    replicated sharding of them."""
    from coral_tpu.config import DictConfig
    from coral_tpu.parallel import create_mesh, replicated
    from coral_tpu.training.model_setup import load_model_setup

    setup = load_model_setup(DictConfig(config))
    params = setup.init_params(jax.random.PRNGKey(0))
    mesh = create_mesh((1, 1))
    param_sh = jax.tree.map(lambda _: replicated(mesh), params)
    return setup, jax.device_put(params, param_sh), mesh, param_sh


def _chip_smoke_writer():
    """``chip_smoke.py``'s safetensors writer, with which it writes the
    checkpoints its serving phases load (the card has no safetensors)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.write_safetensors


def _file_tensors(path: Path) -> dict:
    return {k: v.float() for k, v in load_torch_state_dict(path).items()}


# -- the reader ---------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_reader_and_writer_agree_with_safetensors(dtype, tmp_path):
    """The port's reader gives safetensors' tensors bit for bit, and
    safetensors reads the files of chip_smoke.py's writer bit for bit
    (safetensors.numpy too, which has no bfloat16)."""
    write_safetensors = _chip_smoke_writer()
    rng = np.random.default_rng(0)
    tensors = {f"t{i}": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
               for i, shape in enumerate([(3, 5), (7,), (2, 3, 4), (0, 4), ()])}
    tensors["other"] = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    theirs, ours = tmp_path / "theirs.safetensors", tmp_path / "ours.safetensors"
    safetensors.torch.save_file(tensors, str(theirs), metadata={"format": "pt"})
    write_safetensors(ours, tensors, metadata={"format": "pt"})
    for got in (read_safetensors(theirs), safetensors.torch.load_file(str(ours))):
        assert got.keys() == tensors.keys()
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                               v.reshape(-1).view(torch.uint8)), k
    if dtype != torch.bfloat16:
        for k, v in safetensors.numpy.load_file(str(ours)).items():
            np.testing.assert_array_equal(v, tensors[k].numpy())
    with safetensors.safe_open(str(ours), "pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_reader_maps_the_file_privately(tmp_path):
    path = tmp_path / "x.safetensors"
    safetensors.torch.save_file({"w": torch.ones(4, 4)}, str(path))
    before = path.read_bytes()
    w = read_safetensors(path)["w"]
    w.zero_()  # the view is the mapping's copy-on-write page, not the file
    assert path.read_bytes() == before
    assert torch.equal(read_safetensors(path)["w"], torch.ones(4, 4))


def test_reader_refuses_other_dtypes(tmp_path):
    path = tmp_path / "i.safetensors"
    safetensors.torch.save_file({"ids": torch.arange(3)}, str(path))
    with pytest.raises(ValueError, match="I64"):
        read_safetensors(path)


# -- wav2vec2 -------------------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,weight_norm", W2V2_CASES)
def test_wav2vec2_checkpoint_serves_as_in_jax(fmt, weight_norm, tmp_path):
    """One directory through both setups: the same transcripts and frame
    lengths, logits within 1e-4 of max |JAX|, every tensor the file's."""
    from coral_tpu.audio.features import znorm

    directory = tmp_path / "wav2vec2-tiny"
    path = hf.w2v2_checkpoint(directory, seed=1, fmt=fmt, weight_norm=weight_norm)
    config = _w2v2_config(directory, tmp_path / "jax-model")
    setup = port_setup.load_model_setup(config, device="cpu")
    model = setup.init_params(seed=0)
    jax_setup, params, mesh, param_sh = _jax(config)

    own = model.state_dict()
    for key, value in _file_tensors(path).items():
        if "pos_conv_embed" not in key or key.endswith("bias"):
            assert torch.equal(own[key], value), key
    want_pos = np.asarray(params["wav2vec2"]["encoder"]["pos_conv_embed"]["conv_kernel"])
    got_pos = own[f"{hf.POS_CONV}.weight"].numpy().transpose(2, 1, 0)
    assert _rel(got_pos, want_pos) <= 1e-6

    batch = _batch()
    predict = setup.make_predictor(model)
    texts = predict(batch)
    assert texts == jax_setup.make_predictor(mesh, param_sh)(params, batch) and all(texts)
    logits, frames = predict.logits(batch)
    jax_logits, jax_frames = jax_setup.model.apply(
        {"params": params}, znorm(batch["input_values"], batch["input_lengths"]),
        batch["input_lengths"], deterministic=True)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jax_frames))
    assert _rel(logits.numpy(), jax_logits) <= REL_TOL


def _f32_copy(path: Path, directory: Path) -> None:
    """``directory`` holding an F32 safetensors file of ``path``'s values
    (and the Whisper tokenizer files beside it)."""
    directory.mkdir()
    safetensors.torch.save_file({k: v.float() for k, v in read_safetensors(path).items()},
                                str(directory / "model.safetensors"))
    for name in ("vocab.json", "merges.txt"):
        if (path.parent / name).exists():
            (directory / name).write_bytes((path.parent / name).read_bytes())


@pytest.mark.parametrize("family", ["wav2vec2-tiny", "whisper-tiny_test"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_storage_loads_the_values_it_holds(family, dtype, tmp_path):
    """An F16 or BF16 file loads into fp32 parameters bit for bit the port's
    load of an F32 file of the same values, and serves the same logits."""
    half_dir, full_dir = tmp_path / "half" / family, tmp_path / "full" / family
    half_dir.parent.mkdir()
    full_dir.parent.mkdir()
    write = hf.w2v2_checkpoint if family.startswith("wav2vec2") else hf.whisper_checkpoint
    path = write(half_dir, seed=3, dtype=dtype)
    assert {v.dtype for v in read_safetensors(path).values()} == {dtype}
    _f32_copy(path, full_dir)
    config = _w2v2_config if family.startswith("wav2vec2") else _whisper_config
    models = [port_setup.load_model_setup(config(d), device="cpu").init_params(seed=0)
              for d in (half_dir, full_dir)]
    got, want = (m.state_dict() for m in models)
    assert all(v.dtype == torch.float32 for v in got.values())
    assert all(torch.equal(got[k], want[k]) for k in want)
    if family.startswith("wav2vec2"):
        batch = _batch(seed=4)
        outs = [port_setup.GreedyCtcPredictor(m, None).logits(batch)[0] for m in models]
    else:
        feats = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (2, 200, 80)).astype(np.float32))
        with torch.no_grad():
            outs = [PW.encode(m, feats) for m in models]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("family", ["wav2vec2-tiny", "whisper-tiny_test"])
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_sharded_checkpoint_loads_as_the_whole_file(family, fmt, tmp_path):
    """A checkpoint that ``save_pretrained`` wrote in shards (as it writes
    one above its shard size: an fp32 XLS-R-2B is about 8.6 GB) loads
    through its index into the parameters of the same model saved whole,
    bit for bit, and serves the same logits. The JAX setups find no such
    checkpoint and serve seeded weights (ROADMAP.md Queue 3)."""
    from coral_tpu.training.model_setup import _find_local_checkpoint as jax_find

    write = hf.w2v2_checkpoint if family.startswith("wav2vec2") else hf.whisper_checkpoint
    sharded_dir, whole_dir = tmp_path / "sharded" / family, tmp_path / "whole" / family
    index = write(sharded_dir, seed=8, fmt=fmt, shard_bytes=100_000)
    write(whole_dir, seed=8, fmt=fmt)
    shards = set(json.loads(index.read_text())["weight_map"].values())
    assert index.exists() and len(shards) > 1
    assert not (sharded_dir / ("model.safetensors" if fmt == "safetensors"
                               else "pytorch_model.bin")).exists()
    config = _w2v2_config if family.startswith("wav2vec2") else _whisper_config
    setups = [port_setup.load_model_setup(config(d), device="cpu")
              for d in (sharded_dir, whole_dir)]
    assert setups[0]._ckpt == index
    assert jax_find(str(sharded_dir)) is None
    models = [s.init_params(seed=0) for s in setups]
    got, want = (m.state_dict() for m in models)
    assert all(torch.equal(got[k], want[k]) for k in want)
    seeded = port_setup.load_model_setup(config(tmp_path / f"absent-{family}"),
                                         device="cpu").init_params(seed=0).state_dict()
    assert not all(torch.equal(seeded[k], want[k]) for k in want)  # not the seeded weights
    if family.startswith("wav2vec2"):
        batch = _batch(seed=9)
        outs = [port_setup.GreedyCtcPredictor(m, None).logits(batch)[0] for m in models]
    else:
        feats = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (2, 200, 80)).astype(np.float32))
        with torch.no_grad():
            outs = [PW.encode(m, feats) for m in models]
    assert torch.equal(outs[0], outs[1])


def test_shard_index_naming_a_key_its_shard_lacks_raises(tmp_path):
    index = hf.w2v2_checkpoint(tmp_path / "w", seed=8, shard_bytes=100_000)
    manifest = json.loads(index.read_text())
    shard = sorted(set(manifest["weight_map"].values()))[0]
    manifest["weight_map"]["wav2vec2.absent.weight"] = shard
    index.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="'wav2vec2.absent.weight' is not in its shard"):
        load_torch_state_dict(index)


def test_pretraining_checkpoint_keeps_the_seeded_lm_head(tmp_path, caplog):
    """facebook/wav2vec2-xls-r-300m is a Wav2Vec2ForPreTraining checkpoint:
    its heads (quantizer, project_q, project_hid) are dropped, and the CTC
    head keeps its seeded weights, as ``Wav2Vec2ForCTC.from_pretrained``
    initialises a head the checkpoint lacks; the port logs it."""
    directory = tmp_path / "wav2vec2-tiny-pretraining"
    path = hf.w2v2_checkpoint(directory, seed=5, pretraining=True)
    assert any(k.startswith("quantizer.") for k in read_safetensors(path))
    with caplog.at_level(logging.WARNING):
        model = port_setup.load_model_setup(_w2v2_config(directory),
                                            device="cpu").init_params(seed=0)
    assert "holds no lm_head" in caplog.text
    seeded = port_setup.load_model_setup(_w2v2_config(tmp_path / "absent"),
                                         device="cpu").init_params(seed=0)
    for key in ("lm_head.weight", "lm_head.bias"):
        assert torch.equal(model.state_dict()[key], seeded.state_dict()[key])
    assert torch.equal(model.state_dict()["wav2vec2.masked_spec_embed"],
                       read_safetensors(path)["wav2vec2.masked_spec_embed"])


def test_jax_setup_fails_on_a_pretraining_checkpoint(tmp_path):
    """The reference's fault (ROADMAP.md Queue 3): the JAX setup replaces its
    whole tree by the converted checkpoint, which has no lm_head for a
    pretraining checkpoint, so its model fails at the first apply."""
    from flax.errors import ScopeParamNotFoundError

    directory = tmp_path / "wav2vec2-tiny-pretraining"
    hf.w2v2_checkpoint(directory, seed=5, pretraining=True)
    jax_setup, params, _, _ = _jax(_w2v2_config(directory, tmp_path / "jax-model"))
    assert "lm_head" not in params
    batch = _batch()
    with pytest.raises(ScopeParamNotFoundError, match="lm_head"):
        jax_setup.model.apply({"params": params}, batch["input_values"],
                              batch["input_lengths"], deterministic=True)


def test_lm_head_of_another_vocabulary_raises(tmp_path):
    directory = tmp_path / "wav2vec2-tiny-40"
    hf.w2v2_checkpoint(directory, seed=6, vocab_size=40)
    setup = port_setup.load_model_setup(_w2v2_config(directory), device="cpu")
    with pytest.raises(ValueError, match="40 rows.* 46 ids"):
        setup.init_params(seed=0)


def _meta(family: str):
    with torch.device("meta"):
        if family == "wav2vec2":
            return Wav2Vec2ForCTC(Wav2Vec2Config.tiny())
        return PW.WhisperForConditionalGeneration(PW.WhisperConfig.tiny_test(vocab_size=1864))


@pytest.mark.parametrize("family,edit,match", [
    ("wav2vec2", "drop:wav2vec2.encoder.layers.1.final_layer_norm.bias",
     "missing.*layers.1.final_layer_norm.bias"),
    ("wav2vec2", "add:wav2vec2.adapter.proj.weight", "unexpected.*adapter.proj.weight"),
    ("wav2vec2", "drop:lm_head.bias", "lm_head.weight.*without the other"),
    ("wav2vec2", "shape:wav2vec2.feature_projection.projection.bias",
     "shapes.*feature_projection.projection.bias"),
    ("whisper", "drop:model.encoder.conv2.bias", "missing.*model.encoder.conv2.bias"),
    ("whisper", "add:model.decoder.layers.0.encoder_attn.k_proj.bias",
     "unexpected.*encoder_attn.k_proj.bias"),
    ("whisper", "untie:proj_out.weight", "proj_out.weight differs"),
])
def test_keys_the_model_lacks_or_lacks_from_it_raise(family, edit, match, tmp_path):
    path = (hf.w2v2_checkpoint(tmp_path / "w", seed=7) if family == "wav2vec2"
            else hf.whisper_checkpoint(tmp_path / "w", seed=7, fmt="bin"))
    sd = dict(load_torch_state_dict(path))
    op, key = edit.split(":")
    if op == "drop":
        del sd[key]
    elif op == "add":
        sd[key] = torch.zeros(32)
    elif op == "shape":
        sd[key] = torch.zeros(31)
    else:
        sd[key] = sd[key] + 1.0
    convert = wav2vec2_state_dict_from_hf if family == "wav2vec2" else whisper_state_dict_from_hf
    with pytest.raises(ValueError, match=match):
        convert(sd, _meta(family))


def _zero_stride(manifest: dict) -> dict:
    """The manifest's tensors as zero-stride fp32 arrays: no memory behind
    their shapes."""
    zero = np.zeros(1, np.float32)
    return {name: torch.from_numpy(np.lib.stride_tricks.as_strided(
                zero, shape, (0,) * len(shape), writeable=True))
            for name, shape in manifest["tensors"].items()}


@pytest.mark.parametrize("name", ["wav2vec2-xls-r-300m", "whisper-large-v3"])
def test_golden_manifest_maps_exactly_at_full_scale(name):
    """Every tensor of the published checkpoint's manifest maps onto the
    port's model at its config's full widths, and every tensor of the model
    comes from it: the pretraining heads dropped, the weight norm folded
    (to the conv's (1024, 64, 128)), proj_out the tied embedding; only
    XLS-R's lm_head is absent (a pretraining checkpoint)."""
    manifest = json.loads((GOLDEN / f"{name}.json").read_text())
    sd = _zero_stride(manifest)
    with torch.device("meta"):
        if name.startswith("wav2vec2"):
            model = Wav2Vec2ForCTC(Wav2Vec2Config.xls_r_300m(vocab_size=46))
            mapped = wav2vec2_state_dict_from_hf(sd, model)
        else:
            model = PW.WhisperForConditionalGeneration(PW.WhisperConfig.large_v3(
                vocab_size=manifest["config"]["vocab_size"]))
            mapped = whisper_state_dict_from_hf(sd, model)
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    absent = {"lm_head.weight", "lm_head.bias"} if name.startswith("wav2vec2") else set()
    assert set(own) - set(mapped) == absent and set(mapped) <= set(own)
    assert all(tuple(mapped[k].shape) == own[k] for k in mapped)
    if absent:
        assert mapped[f"{hf.POS_CONV}.weight"].device.type == "meta"


# -- Whisper --------------------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_whisper_checkpoint_serves_as_in_jax(fmt, tmp_path):
    """One directory through both setups: the tokenizer from its vocab.json
    (1,864 ids), the encoder output and three decode steps' logits within 1e-4
    of max |JAX|, the same greedy ids and transcripts."""
    from coral_tpu.models import whisper as JW

    directory = tmp_path / "whisper-tiny_test"
    path = hf.whisper_checkpoint(directory, seed=2, fmt=fmt)
    config = _whisper_config(directory, tmp_path / "jax-model")
    setup = port_setup.load_model_setup(config, device="cpu")
    jax_setup, params, mesh, param_sh = _jax(config)
    assert setup.tokenizer.vocab_size == jax_setup.tokenizer.vocab_size == hf.WHISPER_VOCAB
    assert setup.model_config.vocab_size == hf.WHISPER_VOCAB
    model = setup.init_params(seed=0)
    own = model.state_dict()
    file = _file_tensors(path)
    assert all(torch.equal(own[k], v) for k, v in file.items() if k != "proj_out.weight")

    jc = jax_setup.model_config
    feats = (np.random.default_rng(3).standard_normal((2, 200, 80))).astype(np.float32)
    enc = np.asarray(JW.encode(params, jc, feats))
    with torch.no_grad():
        got = PW.encode(model, torch.from_numpy(feats)).numpy()
    assert _rel(got, enc) <= REL_TOL
    jkv = JW.precompute_cross_kv(params, jc, enc)
    jcache = JW.init_self_cache(jc, 2, 16)
    with torch.no_grad():
        pkv = PW.precompute_cross_kv(model, torch.from_numpy(enc.copy()))
    pcache = PW.init_self_cache(model.config, 2, 16, "cpu")
    tokens = np.array(setup.tokenizer.forced_decoder_ids[:1] * 2)
    for pos in range(3):
        jlogits, jcache = JW.decode_step(params, jc, tokens, np.int32(pos), jcache, jkv)
        with torch.no_grad():
            plogits, pcache = PW.decode_step(model, torch.from_numpy(tokens), pos, pcache, pkv)
        assert _rel(plogits.numpy(), jlogits) <= REL_TOL
        tokens = np.asarray(jlogits).argmax(-1)
    forced = setup.tokenizer.forced_decoder_ids
    eos = setup.tokenizer.eos_token_id
    want = np.asarray(JW.greedy_generate(params, jc, feats, np.asarray(forced), 16, eos))
    got = PW.greedy_generate(model, torch.from_numpy(feats), forced, 16, eos).numpy()
    np.testing.assert_array_equal(got, want)

    rng = np.random.default_rng(4)
    audio = np.zeros((2, 32_000), np.float32)
    audio[0] = rng.standard_normal(32_000) * 0.1
    audio[1, :20_000] = rng.standard_normal(20_000) * 0.3
    batch = {"input_values": audio, "input_lengths": np.array([32_000, 20_000], np.int32)}
    want = jax_setup.make_predictor(mesh, param_sh)(params, batch)
    assert setup.make_predictor(model)(batch) == want


def test_whisper_checkpoint_without_its_vocabulary_is_not_used(tmp_path, caplog):
    """As the JAX setup: with no vocab.json beside the checkpoint the setup
    takes the byte-fallback tokenizer and seeded weights, and warns."""
    directory = tmp_path / "whisper-tiny_test"
    hf.whisper_checkpoint(directory, seed=2)
    (directory / "vocab.json").unlink()
    with caplog.at_level(logging.WARNING):
        setup = port_setup.load_model_setup(_whisper_config(directory), device="cpu")
    assert "byte-fallback tokenizer and random init" in caplog.text
    seeded = port_setup.load_model_setup(_whisper_config(tmp_path / "absent-tiny_test"),
                                         device="cpu")
    got, want = setup.init_params(seed=0).state_dict(), seeded.init_params(seed=0).state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_large_v3_directory_builds_the_v3_vocabulary(tmp_path):
    """vocab_size follows the tokenizer: a large-v3 directory's vocab.json of
    50,257 BPE tokens (its specials stripped) gives the golden manifest's
    51,866 ids, the "yue" language token included."""
    directory = tmp_path / "whisper-large-v3"
    directory.mkdir()
    byte_units = json.loads(_byte_fallback_vocab(tmp_path))
    vocab = {**byte_units, **{f"tok{i}": i for i in range(len(byte_units), 50_257)},
             "<|endoftext|>": 50_257}
    (directory / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (directory / "merges.txt").write_text("", encoding="utf-8")
    (directory / "model.safetensors").write_bytes(b"")  # the setup reads no weights
    setup = port_setup.load_model_setup(_whisper_config(directory), device="cpu")
    golden = json.loads((GOLDEN / "whisper-large-v3.json").read_text())["config"]
    assert setup.tokenizer.vocab_size == setup.model_config.vocab_size == golden["vocab_size"]
    assert setup.model_config.d_model == golden["d_model"]


def _byte_fallback_vocab(tmp_path: Path) -> str:
    from coral_tpu_torch.text.whisper_tokenizer import WhisperTokenizer

    WhisperTokenizer.byte_fallback().save_pretrained(tmp_path / "bytes")
    return (tmp_path / "bytes" / "vocab.json").read_text(encoding="utf-8")


# -- the pretrained-id branch ---------------------------------------------------------------------


@pytest.mark.parametrize("model_id", ["example/wav2vec2-tiny-random", "openai/whisper-tiny"])
def test_pretrained_branch_builds_the_jax_branchs_config(model_id, monkeypatch):
    """``load_saved_predictor``'s pretrained-id branch hands its setup the
    config the JAX branch builds (coral_tpu/evaluation/evaluate.py:169-187),
    the JAX branch's model_dir aside: sampling_rate (Whisper's chunk_length
    follows it), lower_case, language and gradient_checkpointing included."""
    import coral_tpu.training.model_setup as jax_model_setup
    import coral_tpu_torch.evaluation.evaluate as port_evaluate
    from coral_tpu.config import DictConfig
    from coral_tpu.evaluation.evaluate import load_saved_predictor as jax_load_saved_predictor

    class Captured(Exception):
        pass

    seen = []

    def capture(config, **_):
        seen.append(json.loads(json.dumps(dict(config), default=dict)))
        raise Captured

    monkeypatch.setattr(jax_model_setup, "load_model_setup", capture)
    monkeypatch.setattr(port_evaluate, "load_model_setup", capture)
    config = {"model_id": model_id, "sampling_rate": 8_000, "lower_case": True,
              "characters_to_keep": hf.CHARS, "max_seconds_per_example": 30, "no_lm": False}
    with pytest.raises(Captured):
        jax_load_saved_predictor(DictConfig(config))
    with pytest.raises(Captured):
        port_evaluate.load_saved_predictor(config, device="cpu")
    want, got = seen
    del want["model_dir"]
    assert got == want
