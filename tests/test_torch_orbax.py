"""The port's reader of tip_tpu's orbax checkpoints (utils/orbax_read.py)
and the restore, resume and CLIs built on it, against tip_tpu's own
save_checkpoint and restore_checkpoint (orbax, tensorstore) on the CPU.

The fixture tests/data/orbax_tiny (scripts/torch_make_orbax_fixture.py) is
tip_tpu's checkpoint at path S's widths after two of its train steps;
more are written on the fly by tip_tpu's save_checkpoint. tensorstore,
which this test host has, is the oracle of the OCDBT layer: the cases that
need it skip without it. The trained checkpoint of the clone's history is
read where its commit is present (tests/trained_checkpoint.py).
"""

import hashlib
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.train import train as JT
from tip_tpu_torch.cli import evaluate as TCE
from tip_tpu_torch.cli import live_demo as TLD
from tip_tpu_torch.cli import serve as TSV
from tip_tpu_torch.cli import train as TCT
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.train import train as TT
from tip_tpu_torch.utils import orbax_read as OR

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "orbax_tiny"
DIGESTS = json.loads((ROOT / "tests" / "data" /
                      "orbax_tiny.json").read_text())
CORPUS = ROOT / "artifacts" / "corpus_run_v3" / "corpus_extra"
S = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
         rnn_hid_size=24)


def _tensorstore():
    return pytest.importorskip("tensorstore")


def leaf_name(path) -> str:
    """orbax's parameter name of a pytree path: its keys joined by dots."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", None)))) for k in path)


def jax_arrays(state) -> dict:
    """{orbax name: numpy array} of every array leaf of tip_tpu's state."""
    tree = {"params": state.params, "opt_state": state.opt_state,
            "step": state.step, "rng": state.rng}
    return {leaf_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _digest(a):
    return dict(shape=list(a.shape), dtype=a.dtype.str,
                sha256=hashlib.sha256(a.tobytes()).hexdigest())


def tiny_jcfg(**kw):
    model_kw = {k: kw.pop(k) for k in list(kw) if k in (
        "size_s", "with_acc_sum", "compute_dtype")}
    return JT.TrainConfig(model=JM.ModelConfig(**S, **model_kw),
                          batch_size=4, seq_len=10, lr=1e-3, epochs=20,
                          **kw)


def tiny_tcfg(**kw):
    model_kw = {k: kw.pop(k) for k in list(kw) if k in (
        "size_s", "with_acc_sum", "compute_dtype", "tf_layers",
        "rnn_hid_size", "in_dropout", "past_dropout", "layer_dropout")}
    widths = {**S, **{k: model_kw.pop(k) for k in ("tf_layers",
                                                   "rnn_hid_size")
                      if k in model_kw}}
    return TT.TrainConfig(model=TM.ModelConfig(**widths, **model_kw),
                          batch_size=4, seq_len=10, lr=1e-3, epochs=20,
                          **kw)


FIXTURE_CFG = dict(optimizer="AdamW", clip=5.0)


def write_jax_checkpoint(path, jcfg, seed=0):
    """tip_tpu's init state with every moment, count and the step made
    non-zero, saved by tip_tpu's save_checkpoint at step 7."""
    rng = np.random.default_rng(seed)
    st = JT.init_state(jcfg, jax.random.PRNGKey(seed))

    def fill(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(rng.normal(size=x.shape), x.dtype)
        return jnp.full(x.shape, 7, x.dtype)
    st = JT.TrainState(params=st.params,
                       opt_state=jax.tree_util.tree_map(fill, st.opt_state),
                       step=jnp.asarray(7, jnp.int32), rng=st.rng)
    JT.save_checkpoint(str(path), st, 7)
    return path


# ---------------------------------------------------------------------------
# (a) the fixture against its digests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_arrays():
    return OR.read_orbax(OR.step_dir(str(FIXTURE)))


@pytest.mark.parametrize("group", ["params", "opt_state", "step", "rng"])
def test_fixture_reads_as_tip_tpus_restore(fixture_arrays, group):
    """Every array of the in-tree fixture: its name, shape, dtype and bytes
    equal to tip_tpu's restore (tests/data/orbax_tiny.json)."""
    want = {k: v for k, v in DIGESTS["arrays"].items()
            if k.split(".")[0] == group}
    got = {k: _digest(v) for k, v in fixture_arrays.items()
           if k.split(".")[0] == group}
    assert want and got == want
    assert set(fixture_arrays) == set(DIGESTS["arrays"])


def test_fixture_steps_and_paths(fixture_arrays):
    assert OR.is_orbax_dir(str(FIXTURE))
    assert OR.is_orbax_dir(str(FIXTURE / "2"))
    assert OR.orbax_steps(str(FIXTURE)) == [2] == [OR.latest_step(
        str(FIXTURE))]
    assert OR.step_dir(str(FIXTURE)) == str(FIXTURE / "2")
    assert OR.step_dir(str(FIXTURE / "2")) == str(FIXTURE / "2")
    assert int(fixture_arrays["step"]) == 2
    assert int(fixture_arrays["opt_state.1.0.count"]) == 2
    assert not OR.is_orbax_dir(str(ROOT / "tests"))
    with pytest.raises(FileNotFoundError, match="no step 3"):
        OR.step_dir(str(FIXTURE), 3)


# ---------------------------------------------------------------------------
# (b) checkpoints written on the fly by tip_tpu
# ---------------------------------------------------------------------------

FLY = {
    "adam_clip": dict(optimizer="Adam", clip=5.0),
    "adamw_clip": dict(optimizer="AdamW", clip=5.0),
    "adam_noclip": dict(optimizer="Adam", clip=0.0),
    "adamw_noclip": dict(optimizer="AdamW", clip=0.0),
    "two_sbp_no_sum": dict(optimizer="Adam", clip=5.0, n_sbps=2,
                           size_s=119, with_acc_sum=False),
    "bf16": dict(optimizer="AdamW", clip=5.0, compute_dtype="bfloat16"),
}


@pytest.fixture(scope="module")
def fly(tmp_path_factory):
    """Per case: (checkpoint directory, tip_tpu's restore as arrays)."""
    out = {}
    for i, (name, kw) in enumerate(FLY.items()):
        path = tmp_path_factory.mktemp(name) / "ckpt"
        write_jax_checkpoint(path, tiny_jcfg(**kw), seed=i)
        out[name] = (path, jax_arrays(JT.restore_checkpoint(
            str(path), tiny_jcfg(**kw))))
    return out


@pytest.mark.parametrize("case", list(FLY))
def test_on_the_fly_checkpoint_equals_tip_tpus_restore(fly, case):
    path, want = fly[case]
    got = OR.read_orbax(OR.step_dir(str(path)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k
    assert got["params.out.b"].dtype == np.float32


@pytest.mark.parametrize("case", list(FLY))
def test_orbax_restore_maps_params_moments_step_and_rng(fly, case):
    """restore_checkpoint of the port: params and Adam's moments found by
    name wherever the chain keeps them, the step, and generators seeded
    from the key by the documented rule (two restores draw alike)."""
    kw = dict(FLY[case])
    path, want = fly[case]
    cfg = tiny_tcfg(**kw)
    st = TT.restore_checkpoint(str(path), cfg, device="cpu")
    adam = TT.orbax_adam_prefix(cfg)
    assert adam == ("opt_state.1.0" if kw["clip"] > 0 else "opt_state.0.0")
    assert f"{adam}.count" in want
    for k, p in st.model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad
        assert np.array_equal(p.detach().numpy(), want[f"params.{k}"]), k
        assert np.array_equal(st.mu[k].numpy(), want[f"{adam}.mu.{k}"]), k
        assert np.array_equal(st.nu[k].numpy(), want[f"{adam}.nu.{k}"]), k
    assert int(st.step) == 7 and st.step.dtype == torch.int64
    again = TT.restore_checkpoint(str(path), cfg, device="cpu")
    assert torch.equal(st.gen.get_state(), again.gen.get_state())
    assert torch.equal(st.noise_gen.get_state(), again.noise_gen.get_state())
    k0, k1 = (int(x) for x in want["rng"])
    s = (k0 << 32) | k1
    assert torch.equal(st.gen.get_state(),
                       torch.Generator().manual_seed(s).get_state())
    assert torch.equal(st.noise_gen.get_state(), torch.Generator().manual_seed(
        (s + 1) % 2 ** 64).get_state())


def test_optimizer_names_match_tip_tpus_chain(fly):
    for name, kw in FLY.items():
        _, want = fly[name]
        cfg = tiny_tcfg(**kw)
        params = {k[len("params."):] for k in want if k.startswith("params.")}
        assert TT.orbax_optimizer_names(cfg, params) == {
            k for k in want if k.startswith("opt_state.")}, name


# ---------------------------------------------------------------------------
# (c) the OCDBT layer against tensorstore
# ---------------------------------------------------------------------------

def _ts_store(ts, root):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": f"file://{root}"}).result()


def _hold_against_tensorstore(ts, root):
    kv = _ts_store(ts, root)
    theirs = sorted(kv.list().result())
    with OR.OcdbtStore(str(root)) as mine:
        assert mine.keys() == theirs
        for k in theirs:
            assert mine.read(k) == kv.read(k).result().value, k
    return len(theirs)


@pytest.mark.parametrize("which", ["fixture_root", "fixture_process_0",
                                   "on_the_fly"])
def test_keys_and_bytes_equal_tensorstores(which, fly):
    ts = _tensorstore()
    step = FIXTURE / "2" / "default"
    root = {"fixture_root": step,
            "fixture_process_0": step / "ocdbt.process_0",
            "on_the_fly": Path(OR.step_dir(str(fly["adam_noclip"][0])))
            / "default"}[which]
    assert _hold_against_tensorstore(ts, root) == 2 * len(DIGESTS["arrays"])


@pytest.mark.parametrize("node_bytes", [400, 4000])
def test_deep_btree_and_version_tree_equal_tensorstores(node_bytes,
                                                        tmp_path):
    """A store tensorstore writes with small nodes (b-trees 2-5 levels
    deep, interior keys cut by their common prefix), values both inline and
    by reference, over many versions (the version tree beyond the
    manifest)."""
    ts = _tensorstore()
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"max_decoded_node_bytes": node_bytes,
                                     "max_inline_value_bytes": 16,
                                     "version_tree_arity_log2": 1}}).result()
    rng = np.random.default_rng(0)
    for r in range(5):
        with ts.Transaction() as txn:
            for i in range(90):
                key = f"params.layers.{r}.w{i:03d}/0.0".encode()
                kv.with_transaction(txn).write(
                    key, rng.bytes(int(rng.choice([3, 10, 40])))).result()
    kv.write(b"params.layers.0.w001/0.0", None).result()
    assert _hold_against_tensorstore(ts, tmp_path) == 5 * 90 - 1


def test_numbered_manifest_is_refused(tmp_path):
    ts = _tensorstore()
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv.write(b"a", b"x").result()
    with pytest.raises(ValueError, match="manifest_kind 1 is not read"):
        OR.OcdbtStore(str(tmp_path))


# ---------------------------------------------------------------------------
# (d) the trained checkpoint of the clone's history
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    import trained_checkpoint as TC
    reason = TC.missing()
    if reason:
        pytest.skip(reason)
    ckpt = TC.extract_checkpoint(tmp_path_factory.mktemp("trained"))
    cfg = TC.config_from_checkpoint(ckpt)
    jst = JT.restore_checkpoint(str(ckpt), JT.TrainConfig(
        model=cfg, n_sbps=5, optimizer="AdamW"))
    return TC, ckpt, cfg, jst


def test_trained_checkpoint_bit_equal_to_tip_tpus_restore(trained):
    TC, ckpt, cfg, jst = trained
    meta = json.loads((ckpt / str(TC.STEP) / "default" /
                       "_METADATA").read_text())
    assert len(meta["tree_metadata"]) == 222
    want = jax_arrays(jst)
    got = OR.read_orbax(OR.step_dir(str(ckpt)))
    assert len(got) == len(want) == 220     # 222 leaves, 2 of them empty
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_trained_checkpoint_runs_as_tip_tpus(trained):
    """The port's restore of the trained checkpoint (params only, as
    cli/evaluate reads it) through the port's run_offline in float64 over
    300 frames equals tip_tpu's run of tip_tpu's own restore (1e-8, as
    tests/test_torch_trained_weights.py)."""
    from tip_tpu.ops import kinematics as jkin
    from tip_tpu.runtime import runner as JR
    from tip_tpu_torch.ops import kinematics as tkin
    from tip_tpu_torch.runtime import runner as TR
    TC, ckpt, cfg, jst = trained
    tcfg = TR.RunnerConfig(model=TC.port_config(cfg))
    st = TT.restore_checkpoint(str(ckpt), TT.TrainConfig(
        model=tcfg.model, n_sbps=5, optimizer="AdamW"), params_only=True,
        device="cpu")
    model = st.model.double().requires_grad_(False)
    imu, s_init = TC.load_motion()
    t_out = TR.run_offline(model, tcfg, tkin.amass_skeleton(
        dtype=torch.float64), s_init, imu, device="cpu")
    p64 = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float64),
                                 jst.params)
    j_out = JR.run_offline(p64, JR.RunnerConfig(model=cfg),
                           jkin.amass_skeleton(dtype=np.float64), s_init,
                           imu)
    for name, t, j in zip(("s_traj", "c_traj", "viz"), t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-8,
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# (e) what the restore and the reader refuse
# ---------------------------------------------------------------------------

def test_shape_mismatch_raises_tip_tpus_error():
    with pytest.raises(ValueError, match=r"does not match the model config "
                       r"\(size_s=131, with_acc_sum=False\)"):
        TT.restore_checkpoint(str(FIXTURE), tiny_tcfg(
            with_acc_sum=False, **FIXTURE_CFG), device="cpu")


def test_packed_qkv_layout_raises(tmp_path):
    jcfg = tiny_jcfg(**FIXTURE_CFG)
    st = JT.init_state(jcfg)
    params = dict(st.params)
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        lp["w_qkv"] = jnp.concatenate([lp.pop(f"w_{n}") for n in "qkv"], 1)
        layers.append(lp)
    params["layers"] = layers
    JT.save_checkpoint(str(tmp_path / "old"), JT.TrainState(
        params=params, opt_state=(), step=st.step, rng=st.rng), 1)
    with pytest.raises(ValueError, match="old packed-qkv parameter layout"):
        TT.restore_checkpoint(str(tmp_path / "old"),
                              tiny_tcfg(**FIXTURE_CFG), device="cpu")


def test_params_only_accepts_another_optimizer_with_a_warning(
        fixture_arrays):
    cfg = tiny_tcfg(optimizer="Adam", clip=0.0)
    with pytest.warns(UserWarning, match="different optimizer-state "
                      "structure than TrainConfig\\(optimizer='Adam'\\); "
                      "restoring params/step/rng only"):
        st = TT.restore_checkpoint(str(FIXTURE), cfg, params_only=True,
                                   device="cpu")
    assert int(st.step) == 2
    assert all(not v.any() for v in st.mu.values())
    for k, p in st.model.named_parameters():
        assert np.array_equal(p.detach().numpy(),
                              fixture_arrays[f"params.{k}"]), k


@pytest.mark.parametrize("kw,match", [
    (dict(tf_layers=1), "different PARAMETER structure"),
    (dict(rnn_hid_size=16), "SHAPES do not match the model config"),
])
def test_params_only_still_refuses_other_parameters(kw, match):
    with pytest.raises(ValueError, match=match):
        TT.restore_checkpoint(str(FIXTURE), tiny_tcfg(optimizer="Adam", **kw),
                              params_only=True, device="cpu")


@pytest.mark.parametrize("kw", [dict(optimizer="Adam", clip=5.0),
                                dict(optimizer="AdamW", clip=0.0)])
def test_full_resume_refuses_another_optimizer(kw):
    with pytest.raises(ValueError, match="different optimizer-state "
                       "structure"):
        TT.restore_checkpoint(str(FIXTURE), tiny_tcfg(**kw), device="cpu")


def _copy_fixture(tmp_path):
    dst = tmp_path / "orbax_tiny"
    shutil.copytree(FIXTURE, dst)
    return dst, dst / "2" / "default"


@pytest.mark.parametrize("field,value", [("use_zarr3", True),
                                         ("use_ocdbt", False)])
def test_storage_flags_it_does_not_read_raise(tmp_path, field, value):
    ck, item = _copy_fixture(tmp_path)
    meta = json.loads((item / "_METADATA").read_text())
    meta[field] = value
    (item / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=f"{field} {json.dumps(value)} is "
                       f"not read"):
        OR.read_orbax(OR.step_dir(str(ck)))


def test_truncated_data_file_raises_with_zstds_message(tmp_path):
    """A data file cut inside a chunk's zstd frame: the first value of the
    file (in key order) is the one cut, and zstd names the fault."""
    ck, item = _copy_fixture(tmp_path)
    with OR.OcdbtStore(str(item)) as store:
        refs = {k: store._index[k] for k in store.keys()
                if store._index[k][0] is not None
                and not k.endswith(b".zarray")}
    rel = max({r[0] for r in refs.values()},
              key=lambda f: os.path.getsize(item / f))
    key = min(k for k, r in refs.items() if r[0] == rel)
    _, off, length = refs[key]
    os.truncate(item / rel, off + length // 2)
    with pytest.raises(ValueError, match=f"{key.decode()}: zstd: Src size "
                       f"is incorrect"):
        OR.read_orbax(OR.step_dir(str(ck)))


def test_zstd_errors_and_frames():
    """The zstd layer: a frame with its size and one written as a stream
    (no size), an empty frame, and zstd's own names of errors."""
    zstandard = pytest.importorskip("zstandard")
    data = np.random.default_rng(0).bytes(300_000)
    sized = zstandard.ZstdCompressor(level=1).compress(data)
    streamed = zstandard.ZstdCompressor(level=1).compressobj()
    streamed = streamed.compress(data) + streamed.flush()
    assert bytes(OR.zstd_decompress(sized)) == data
    assert bytes(OR.zstd_decompress(streamed)) == data
    assert bytes(OR.zstd_decompress(
        zstandard.ZstdCompressor().compress(b""))) == b""
    for frame in (sized, streamed):
        with pytest.raises(ValueError, match="zstd: Src size is incorrect"):
            OR.zstd_decompress(frame[:len(frame) // 2])
    with pytest.raises(ValueError, match="zstd: 3 bytes after the frame"):
        OR.zstd_decompress(sized + b"abc")
    with pytest.raises(ValueError, match="not a zstd frame"):
        OR.zstd_decompress(b"not zstd at all")


def test_missing_libzstd_raises_naming_it(monkeypatch):
    monkeypatch.setattr(OR, "LIBZSTD", "libzstd-absent.so.1")
    OR._zstd.cache_clear()
    try:
        with pytest.raises(OSError, match="cannot load libzstd-absent.so.1"):
            OR.zstd_decompress(b"\x28\xb5\x2f\xfd")
    finally:
        OR._zstd.cache_clear()


def test_corrupt_node_fails_its_checksum(tmp_path):
    ck, item = _copy_fixture(tmp_path)
    node = next((item / "d").iterdir())
    b = bytearray(node.read_bytes())
    b[len(b) // 2] ^= 0xFF
    node.write_bytes(bytes(b))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        OR.read_orbax(OR.step_dir(str(ck)))


def _rewrite(ts, item, edits):
    """edits: {key: new bytes or None (delete)} through tensorstore, into
    the root store of a copy."""
    kv = _ts_store(ts, item)
    for k, v in edits.items():
        kv.write(k, v).result()


def _zarray(ts, item, name, **fields):
    kv = _ts_store(ts, item)
    meta = json.loads(kv.read(f"{name}/.zarray".encode()).result().value)
    meta.update(fields)
    return json.dumps(meta).encode()


def test_absent_chunks_take_their_fill_value(tmp_path):
    ts = _tensorstore()
    ck, item = _copy_fixture(tmp_path)
    _rewrite(ts, item, {
        b"params.out.b/0": None,
        b"params.out.b/.zarray": _zarray(ts, item, "params.out.b",
                                         fill_value=0.5),
        b"params.out.w/0.0": None,
        b"params.rnn.b_hh/0": None,
        b"params.rnn.b_hh/.zarray": _zarray(ts, item, "params.rnn.b_hh",
                                            fill_value="NaN")})
    got = OR.read_orbax(OR.step_dir(str(ck)))
    assert np.array_equal(got["params.out.b"], np.full(131, 0.5, np.float32))
    assert np.array_equal(got["params.out.w"], np.zeros((24, 131),
                                                        np.float32))
    assert np.isnan(got["params.rnn.b_hh"]).all()
    assert got["params.rnn.b_hh"].dtype == np.float32


@pytest.mark.parametrize("fields,match", [
    (dict(order="F"), "order 'F' is not read"),
    (dict(compressor={"id": "blosc", "cname": "lz4"}),
     "compressor id 'blosc' is not read"),
    (dict(filters=[{"id": "delta", "dtype": "<f4"}]), "filters"),
    (dict(dtype="|O"), "dtype '|O' is not read"),
])
def test_zarr_layouts_it_does_not_read_raise(tmp_path, fields, match):
    ts = _tensorstore()
    ck, item = _copy_fixture(tmp_path)
    _rewrite(ts, item, {b"params.out.b/.zarray": _zarray(
        ts, item, "params.out.b", **fields)})
    with pytest.raises(ValueError, match=match):
        OR.read_orbax(OR.step_dir(str(ck)))


def test_uncompressed_chunks_and_a_chunk_grid(tmp_path):
    """A zarr v2 array with no compressor over a grid of edge chunks (what
    tip_tpu does not write, the reader reads)."""
    ts = _tensorstore()
    ck, item = _copy_fixture(tmp_path)
    a = np.arange(5 * 7, dtype="<f8").reshape(5, 7)
    edits = {b"params.out.b/.zarray": None, b"params.out.b/0": None}
    meta = dict(chunks=[2, 3], compressor=None, dimension_separator=".",
                dtype="<f8", fill_value=None, filters=None, order="C",
                shape=[5, 7], zarr_format=2)
    edits[b"extra.grid/.zarray"] = json.dumps(meta).encode()
    for i in range(3):
        for j in range(3):
            block = np.zeros((2, 3))
            part = a[2 * i:2 * i + 2, 3 * j:3 * j + 3]
            block[:part.shape[0], :part.shape[1]] = part
            edits[f"extra.grid/{i}.{j}".encode()] = block.tobytes()
    _rewrite(ts, item, edits)
    got = OR.read_orbax(OR.step_dir(str(ck)))
    assert np.array_equal(got["extra.grid"], a)
    assert "params.out.b" not in got


# ---------------------------------------------------------------------------
# (f) a full resume steps as tip_tpu's make_train_step
# ---------------------------------------------------------------------------

def test_full_resume_steps_as_tip_tpu():
    """Noise and dropout off, float64: three steps of the port's restored
    state equal tip_tpu's make_train_step from tip_tpu's restore of the
    same checkpoint to 1e-9 (loss, grad_norm, lr, parameters, moments)."""
    off = dict(in_dropout=0.0, past_dropout=0.0, layer_dropout=0.0)
    jcfg = JT.TrainConfig(model=JM.ModelConfig(**S, **off), batch_size=4,
                          seq_len=10, lr=1e-3, epochs=20,
                          noise_input_hist=0.0, **FIXTURE_CFG)
    tcfg = TT.TrainConfig(model=TM.ModelConfig(**S, **off), batch_size=4,
                          seq_len=10, lr=1e-3, epochs=20,
                          noise_input_hist=0.0, **FIXTURE_CFG)
    jst = JT.restore_checkpoint(str(FIXTURE), jcfg)

    def f64(x):
        return (x.astype(jnp.float64)
                if jnp.issubdtype(x.dtype, jnp.floating) else x)
    jst = JT.TrainState(params=jax.tree_util.tree_map(f64, jst.params),
                        opt_state=jax.tree_util.tree_map(f64, jst.opt_state),
                        step=jst.step, rng=jst.rng)
    tst = TT.restore_checkpoint(str(FIXTURE), tcfg, device="cpu")
    tst.model.double()
    tst.mu = {k: v.double() for k, v in tst.mu.items()}
    tst.nu = {k: v.double() for k, v in tst.nu.items()}
    step = JT.make_train_step(jcfg)
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = (rng.normal(size=(4, 10, 90)),
                 rng.normal(size=(4, 10, 131)) * 0.3,
                 rng.normal(size=(4, 10, 131)) * 0.3)
        jst, jaux = step(jst, *(jnp.asarray(a) for a in batch))
        taux = TT.train_step(tst, tuple(torch.as_tensor(a) for a in batch),
                             tcfg)
        for k in ("loss", "grad_norm", "lr"):
            assert abs(taux[k] - float(jaux[k])) <= 1e-9 * abs(
                float(jaux[k])), k
        for k, v in TM.params_from_jax(jax.tree_util.tree_map(
                np.asarray, jst.params)).items():
            assert (tst.model.state_dict()[k] - v).abs().max() <= 1e-9, k
        adam = jst.opt_state[1][0]
        for k, v in TM.params_from_jax(jax.tree_util.tree_map(
                np.asarray, adam.mu)).items():
            assert (tst.mu[k] - v).abs().max() <= 1e-9, k
        assert int(tst.step) == int(jst.step) == int(adam.count)


# ---------------------------------------------------------------------------
# (g) the CLIs take an orbax directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    """tip_tpu's checkpoint at the CLIs' widths (ModelConfig's defaults, 5
    SBPs, acc-sum, Adam), and the same weights as this package's
    ckpt_*.pt."""
    d = tmp_path_factory.mktemp("full")
    jcfg = JT.TrainConfig(model=JM.ModelConfig(with_acc_sum=True), n_sbps=5)
    JT.save_checkpoint(str(d / "orbax"), JT.init_state(
        jcfg, jax.random.PRNGKey(4)), 3)
    st = TT.restore_checkpoint(str(d / "orbax"), TT.TrainConfig(
        model=TM.ModelConfig(with_acc_sum=True)), device="cpu")
    TT.save_checkpoint(str(d / "pt"), st, 3)
    return d


def test_cli_evaluate_reads_an_orbax_directory(full_width, tmp_path):
    data = tmp_path / "data"
    (data / "syn_AMASS_CMU_v0").mkdir(parents=True)
    shutil.copy(CORPUS / "freeform2_0003.pkl", data / "syn_AMASS_CMU_v0")
    common = ["--data_root", str(data), "--name_contains", "freeform2",
              "--test_len", "120", "--five_sbp",
              "--with_acc_sum", "--device", "cpu"]
    (pm, means, _), (pm2, means2, _) = (
        TCE.main(["--ckpt", str(full_width / c)] + common)
        for c in ("orbax", "pt"))
    assert len(pm) == 1 and means == means2
    assert all(np.isfinite(v) for v in means.values())


def test_cli_train_warm_starts_from_an_orbax_directory(tmp_path,
                                                       fixture_arrays):
    state = TCT.main([
        "--data_prefix", _blobs(tmp_path), "--save_path",
        str(tmp_path / "run"), "--batch_size", "4", "--seq_len", "10",
        "--epochs", "1", "--with_acc_sum", "--optim", "AdamW",
        "--tf_in_dim", "32", "--tf_nhid", "64", "--n_heads", "4",
        "--tf_layers", "2", "--rnn_nhid", "24", "--warm_start",
        str(FIXTURE), "--device", "cpu"])
    assert int(state.step) > 0
    assert (tmp_path / "run" / "ckpt_1.pt").exists()
    # the weights started from the checkpoint's: one AdamW step moves each
    # by about lr
    w = state.model.out.w.detach().numpy()
    assert np.abs(w - fixture_arrays["params.out.w"]).max() < 0.05


def test_cli_serve_and_live_demo_build_from_an_orbax_directory(full_width):
    ckpt = str(full_width / "orbax")
    daemon = TSV.build_daemon(TSV.parse_args(
        ["--ckpt", ckpt, "--five_sbp", "--with_acc_sum", "--capacity", "2",
         "--port", "0", "--device", "cpu"]), log=lambda *_: None)
    try:
        assert daemon.pool.capacity == 2
    finally:
        daemon.stop()
    model, cfg, skel, device = TLD.build_runner(TLD.parse_args(
        ["--ckpt", ckpt, "--five_sbp", "--with_acc_sum", "--device", "cpu"]))
    want = TT.restore_checkpoint(ckpt, TT.TrainConfig(
        model=TM.ModelConfig(with_acc_sum=True)), params_only=True,
        device="cpu").model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert device == torch.device("cpu")


def test_restore_prefers_the_newest_of_both_kinds(tmp_path):
    """A directory holding tip_tpu's orbax steps and this package's
    ckpt_*.pt (a run resumed from tip_tpu's): the newest step is taken."""
    ck = tmp_path / "ckpt"
    shutil.copytree(FIXTURE, ck)
    cfg = tiny_tcfg(**FIXTURE_CFG)
    st = TT.restore_checkpoint(str(ck), cfg, device="cpu")
    assert int(st.step) == 2
    st.step += 3
    TT.save_checkpoint(str(ck), st, 5)
    assert int(TT.restore_checkpoint(str(ck), cfg, device="cpu").step) == 5
    assert int(TT.restore_checkpoint(str(ck), cfg, step=2,
                                     device="cpu").step) == 2


def _blobs(d, n=60):
    rng = np.random.default_rng(0)
    for name, shape in (("imu", (n, 72)), ("sum_imu", (n, 18)),
                        ("s", (n, 131))):
        np.save(d / f"b_{name}.npy",
                (rng.normal(size=shape) * 0.1).astype(np.float32))
    np.save(d / "b_info.npy", np.array([[0, n, 1]], np.int64))
    return str(d / "b")


def test_convergence_script_resumes_from_a_tip_tpu_run(tmp_path):
    """scripts/torch_train_convergence.py's phase_train over a <out>/ckpt
    that holds tip_tpu's orbax steps: it resumes at their step (the
    recipe's AdamW with the clip, the fixture's widths) and writes its own
    checkpoint after."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_train_convergence",
        ROOT / "scripts" / "torch_train_convergence.py")
    TTC = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(TTC)
    out = tmp_path / "run"
    shutil.copytree(FIXTURE, out / "ckpt")
    logs = []
    TTC.phase_train(str(out), _blobs(tmp_path), 3, device="cpu",
                    max_batches=1, save_every=1, log=logs.append, **S,
                    batch_size=8)
    assert "resumed at step 2 (epoch 2)" in logs
    ck = torch.load(out / "ckpt" / "ckpt_3.pt", map_location="cpu",
                    weights_only=True)
    assert ck["step"] == 3
