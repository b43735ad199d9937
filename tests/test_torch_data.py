"""coral_tpu_torch's data pipeline against coral_tpu's, on the CPU.

The port's ``data/`` modules are copies of the JAX package's (``is_main_process``
asks ``torch.distributed`` instead of ``jax.process_index``), plus the CUDA half
of the infeed (``device_put_fn``, ``StreamedBatch``). Held here, exactly:
``BucketBatcher``'s batches, byte for byte, across bucket counts,
accumulation, int16 and float32 audio, fixed label lengths and
``drop_last=False``; ``interleave_iterables``' order for a seed;
``filter_example`` and ``process_example`` (with resampling);
``load_data_for_finetuning``'s train (two epochs) and validation streams on
``synthetic://`` ids and on a local arrow dataset written with ``datasets``;
``load_dataset_for_evaluation`` and ``interpret_dataset_name``. Then the port's
own: ``prefetch_to_device`` keeps the order and re-raises a worker's error,
the CPU ``put_fn`` shares the batch's memory, and ``is_main_process`` reads
``RANK`` first.
"""

import numpy as np
import pytest
import torch

import coral_tpu.data.batching as jax_batching
import coral_tpu.data.interleave as jax_interleave
import coral_tpu.data.loading as jax_loading
import coral_tpu.data.processing as jax_processing
import coral_tpu.data.synthetic as jax_synthetic
import coral_tpu_torch.data.batching as batching
import coral_tpu_torch.data.interleave as interleave
import coral_tpu_torch.data.loading as loading
import coral_tpu_torch.data.processing as processing
import coral_tpu_torch.data.synthetic as synthetic
from coral_tpu.config import compose as jax_compose
from coral_tpu.text.tokenizer import CtcTokenizer as JaxCtcTokenizer
from coral_tpu_torch.config import compose
from coral_tpu_torch.text.tokenizer import CtcTokenizer

torch.set_num_threads(1)

CHARS = "abcdefghijklmnopqrstuvwxyzæøå0123456789éü"


def _samples(n=37, seed=0, max_seconds=4.0):
    """Processed samples (audio_array, labels) of seeded lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(1_000, int(max_seconds * 16_000)))
        out.append({"audio_array": rng.uniform(-1.2, 1.2, length).astype(np.float32),
                    "labels": rng.integers(0, 40, int(rng.integers(1, 90))).astype(np.int32)})
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("num_buckets", [1, 3])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("fixed,drop_last", [(False, True), (True, True), (False, False)],
                         ids=["longest", "fixed_labels", "keep_last"])
def test_bucket_batcher_bytes_match_jax(num_buckets, accum, dtype, fixed, drop_last):
    kw = dict(batch_size=3, accum_steps=accum, max_seconds=4.0, num_buckets=num_buckets,
              max_label_length=80, drop_last=drop_last, audio_transfer_dtype=dtype,
              fixed_label_length=fixed)
    samples = _samples()
    port, jax = batching.BucketBatcher(**kw), jax_batching.BucketBatcher(**kw)
    assert port.bucket_lengths == jax.bucket_lengths
    for _ in range(2):  # the buffers are cleared between passes
        _assert_batches_equal(list(port(iter(samples))), list(jax(iter(samples))))


@pytest.mark.parametrize("probabilities,strategy", [
    (None, "all_exhausted"), ([0.2, 0.5, 0.3], "all_exhausted"), ([0.6, 0.2, 0.2],
                                                                    "first_exhausted")])
def test_interleave_order_matches_jax(probabilities, strategy):
    sources = [lambda: iter(range(5)), lambda: iter(range(100, 103)),
               lambda: iter(range(200, 209))]
    for seed in (0, 4242):
        got = list(interleave.interleave_iterables(sources, probabilities, seed, strategy))
        want = list(jax_interleave.interleave_iterables(sources, probabilities, seed, strategy))
        assert got == want and len(got) > 5


def test_processing_matches_jax():
    examples = synthetic.make_synthetic_examples(n=6, seed=3)
    assert all(np.array_equal(a["audio"]["array"], b["audio"]["array"]) and a["text"] == b["text"]
               for a, b in zip(examples, jax_synthetic.make_synthetic_examples(n=6, seed=3)))
    spelled = synthetic.make_synthetic_examples(n=2, seed=1, spelled=True)
    jax_spelled = jax_synthetic.make_synthetic_examples(n=2, seed=1, spelled=True)
    assert all(np.array_equal(a["audio"]["array"], b["audio"]["array"])
               for a, b in zip(spelled, jax_spelled))
    examples[1]["audio"] = {"array": examples[1]["audio"]["array"][::2], "sampling_rate": 8_000}
    examples[2]["text"] = "  "
    examples[3]["validated"] = "rejected"
    examples[4]["text"] = "Det kostede 25 kroner i 1999!"
    tok, jax_tok = CtcTokenizer.from_characters(CHARS), JaxCtcTokenizer.from_characters(CHARS)
    for ex in examples:
        for bounds in ((1.0, 10.0), (2.0, 3.0)):
            assert processing.filter_example(ex, "audio", "text", *bounds) == \
                jax_processing.filter_example(ex, "audio", "text", *bounds)
        for numerals in (False, True):
            got = processing.process_example(ex, CHARS, "text", "audio", True, numerals, tok)
            want = jax_processing.process_example(ex, CHARS, "text", "audio", True, numerals,
                                                  jax_tok)
            assert got["text"] == want["text"] and got["num_seconds"] == want["num_seconds"]
            assert got["audio_array"].tobytes() == want["audio_array"].tobytes()
            assert np.array_equal(got["labels"], want["labels"])


def _local_dataset(path, n=12, seed=5):
    import datasets

    rng = np.random.default_rng(seed)
    rows = {"audio": [], "sentence": []}
    for i in range(n):
        sr = 8_000 if i % 3 == 0 else 16_000
        rows["audio"].append({"array": rng.uniform(-0.5, 0.5, int(rng.integers(
            1.2 * sr, 6 * sr))).astype(np.float32).tolist(), "sampling_rate": sr})
        rows["sentence"].append(synthetic.DANISH_SENTENCES[i % 8].upper() + " 12")
    datasets.Dataset.from_dict(rows).save_to_disk(str(path / "train"))
    datasets.Dataset.from_dict(rows).save_to_disk(str(path / "val"))


def _streams(splits, epochs=2):
    out = {}
    for name, factory in splits.items():
        runs = [list(factory(epoch)) for epoch in range(epochs if name == "train" else 1)]
        out[name] = [[(s["text"], s["audio_array"].tobytes(), s["labels"].tobytes(),
                       s["input_length"]) for s in run] for run in runs]
    return out


@pytest.mark.parametrize("source", ["synthetic", "local_arrow"])
def test_finetuning_streams_match_jax(tmp_path, source):
    overrides = ["model=test-wav2vec2", "datasets=[synthetic]",
                 "evaluation_datasets=[{id: synthetic://6, val_name: val}]",
                 "max_seconds_per_example=5.0", "datasets.synthetic.id=synthetic://10"]
    configs = [compose("asr_finetuning", overrides=overrides),
               jax_compose("asr_finetuning", overrides=overrides)]
    if source == "local_arrow":
        _local_dataset(tmp_path)
        for cfg in configs:
            cfg.datasets["local"] = {"id": str(tmp_path), "text_column": "sentence",
                                     "audio_column": "audio"}
            cfg.dataset_probabilities = [0.3, 0.7]
            cfg.evaluation_datasets = [{"id": str(tmp_path), "val_name": "val",
                                        "text_column": "sentence"}]
    got = _streams(loading.load_data_for_finetuning(configs[0],
                                                    CtcTokenizer.from_characters(CHARS)))
    want = _streams(jax_loading.load_data_for_finetuning(configs[1],
                                                         JaxCtcTokenizer.from_characters(CHARS)))
    assert got.keys() == want.keys() and len(got) == 2
    assert got == want
    assert all(len(run) > 0 for runs in got.values() for run in runs)


def test_evaluation_stream_and_names_match_jax():
    cfg = {"dataset": "synthetic://5@2-3", "characters_to_keep": CHARS, "lower_case": True,
           "sampling_rate": 16_000, "min_seconds_per_example": 0.5,
           "max_seconds_per_example": 10.0}
    from coral_tpu.config import DictConfig as JaxDictConfig
    from coral_tpu_torch.config import DictConfig

    got = list(loading.load_dataset_for_evaluation(DictConfig(cfg))())
    want = list(jax_loading.load_dataset_for_evaluation(JaxDictConfig(cfg))())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["text"] == w["text"]
        assert g["audio_array"].tobytes() == w["audio_array"].tobytes()
    for name in ("a/b", "a/b::sub", "a/b@rev", "a/b::sub@rev", "synthetic://8"):
        assert loading.interpret_dataset_name(name) == jax_loading.interpret_dataset_name(name)
    for dataset_id in ("synthetic://8", "synthetic://spelled:4", "synthetic://6@2.5-4"):
        assert loading._parse_synthetic_id(dataset_id) == jax_loading._parse_synthetic_id(
            dataset_id)


def test_prefetch_keeps_order_and_raises():
    got = list(batching.prefetch_to_device(iter(range(20)), lambda x: x * 2, prefetch_size=2))
    assert got == [2 * i for i in range(20)]

    def broken():
        yield 1
        yield 2
        raise RuntimeError("source failed")

    seen = []
    with pytest.raises(RuntimeError, match="source failed"):
        for item in batching.prefetch_to_device(broken(), lambda x: x, prefetch_size=1):
            seen.append(item)
    assert seen == [1, 2]
    with pytest.raises(ZeroDivisionError):
        list(batching.prefetch_to_device(iter([1, 0]), lambda x: 1 // x))


def test_cpu_put_shares_the_batch():
    batch = next(iter(batching.BucketBatcher(2, accum_steps=2, max_seconds=4.0, num_buckets=1,
                                             audio_transfer_dtype="int16")(iter(_samples(8)))))
    streamed = batching.device_put_fn("cpu")(batch)
    assert streamed.copied()
    tensors = streamed.wait()
    assert tensors.keys() == batch.keys()
    for k, v in batch.items():
        assert tensors[k].dtype == torch.from_numpy(v).dtype and np.array_equal(
            tensors[k].numpy(), v)
    assert tensors["input_values"].dtype == torch.int16


def test_is_main_process_reads_rank_first(monkeypatch):
    monkeypatch.setenv("RANK", "1")
    assert not loading.is_main_process()
    monkeypatch.setenv("RANK", "0")
    assert loading.is_main_process()
    monkeypatch.delenv("RANK")
    assert loading.is_main_process()  # one process, no process group
