"""Training of the TIP state predictor on one device (twin of
tip_tpu/train/train.py): tip_tpu's kernel configuration
(``rnn_impl="pallas"``, ``encoder_impl="pallas"``, ``dropout_impl="hash"``:
K1, K10, K11, K12 on the card) and its default one (``encoder_impl="xla"``,
the per-op layer loop, with ``dropout_impl="rng"``; the RNN by
``rnn_impl``), a step at a time (``train_step``, ``train_loop``) or an
epoch at a time (``make_epoch_fn``).

The reference recipe: Adam or AdamW, cosine learning rate stepped per
batch with T_max = epochs + 850, global-norm clip 5.0, uniform noise on the
past-state history, fresh windows every epoch, loss = jerk + pose and
root velocity + SBP. The optimizer is written out with optax's formulas, not
torch's (whose clip divides by norm + 1e-6 and whose AdamW decays before
the moment update):

  clip:  g <- g / |g| * clip only when |g| >= clip (|g| over all leaves)
  Adam:  mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu;
         u = (mu / (1 - b1^c)) / (sqrt(nu / (1 - b2^c)) + eps), c = step + 1
  AdamW: u <- u + weight_decay * p
  p <- p + (-lr(step)) u

Random numbers come from two explicit generators of the train state: a
CPU one for the hash masks' seeds (host ints, no device sync) and one on
the device for the history noise, the rng masks (``dropout_impl="rng"``)
and the epoch's window ends (``data.device_sample_epoch``). Both are
checkpointed. ``train_step`` also takes the noise and the seeds as
arguments, so that a test can hand it tip_tpu's. The step count lives on
the device, so that an epoch runs with no host sync (``make_epoch_fn``).

``cfg.model.compute_dtype="bfloat16"`` (the CLI's ``--bf16``) trains as
tip_tpu does: the forward and backward compute in bf16 (K1, K10, K11, K12
in bf16 on the card), while the parameters, Adam's moments, the gradients,
the clip and the checkpoints stay float32. A checkpoint records the
compute dtype it was trained in.

``mesh=`` (a (data, model) ``DeviceMesh`` of ``parallel/mesh.py``, one
process a device) trains as tip_tpu's SPMD program over its mesh: the
batch over the data axis, the encoder's parameters over the model axis
(``shard_state``). Every rank draws what one device draws (the noise and
the masks over the global batch, the seeds, the epoch's window ends) and
takes its part; the loss is the global batch's, its gradients are summed
over the data group before the norm, which counts each parameter once;
clipping and Adam(W) run on each rank's part. The generators and the step
stay replicated. Checkpoints hold the whole state: rank 0 writes what one
device would, and a restore shards it again.
"""

import dataclasses
import math
import os
import re
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from tip_tpu_torch import resolve_device
from tip_tpu_torch.models import losses as L
from tip_tpu_torch.models import tip_model as M
from tip_tpu_torch.parallel import mesh as mesh_lib
from tip_tpu_torch.train import data as data_lib
from tip_tpu_torch.utils import orbax_read

B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_BAD_STEPS = 20
_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: M.ModelConfig = M.ModelConfig()
    n_sbps: int = 5
    batch_size: int = 256
    seq_len: int = 40
    lr: float = 1e-4
    optimizer: str = "Adam"            # or "AdamW"
    weight_decay: float = 1e-4
    clip: float = 5.0
    epochs: int = 1100
    cosine_lr: bool = True
    cosine_extra: int = 850            # T_max = epochs + cosine_extra
    noise_input_hist: float = 0.15
    seed: int = 5104
    log_interval: int = 100
    # tip_tpu's choice of jax.random implementation for the rng masks,
    # "threefry" or "rbg". Both name JAX generators; the port draws the rng
    # masks from one torch.Generator on the device whichever is given
    dropout_rng_impl: str = "threefry"

    def __post_init__(self):
        if self.optimizer not in ("Adam", "AdamW"):
            raise ValueError(f"optimizer must be Adam|AdamW, got "
                             f"{self.optimizer!r}")
        if self.dropout_rng_impl not in ("threefry", "rbg"):
            raise ValueError(f"dropout_rng_impl must be threefry|rbg, got "
                             f"{self.dropout_rng_impl!r}")


@dataclasses.dataclass
class TrainState:
    model: M.TIPModel                  # its parameters require grad
    mu: Dict[str, torch.Tensor]        # Adam's moments, by parameter name
    nu: Dict[str, torch.Tensor]
    step: torch.Tensor                 # () int64 on the device: updates so
                                       # far (Adam's count)
    gen: torch.Generator               # CPU: the hash masks' seeds
    noise_gen: torch.Generator         # on the device: history noise, rng
                                       # masks, the sampler's window ends


def lr_schedule(cfg: TrainConfig):
    """torch CosineAnnealingLR with eta_min=0 stepped per batch:
    lr(t) = lr0 (1 + cos(pi t / T_max)) / 2, periodic beyond T_max. A
    Python int step gives a float; a step tensor gives a float64 tensor on
    its device, computed there."""
    t_max = cfg.epochs + cfg.cosine_extra

    def sched(step):
        if torch.is_tensor(step):
            if not cfg.cosine_lr:
                return torch.full((), cfg.lr, dtype=torch.float64,
                                  device=step.device)
            t = step.to(torch.float64)
            return cfg.lr * (1.0 + torch.cos(math.pi * t / t_max)) / 2.0
        if not cfg.cosine_lr:
            return cfg.lr
        return cfg.lr * (1.0 + math.cos(math.pi * step / t_max)) / 2.0

    return sched


def _state(cfg, model, mu, nu, step, device):
    model.requires_grad_(True)
    return TrainState(
        model=model, mu=mu, nu=nu,
        step=torch.tensor(int(step), dtype=torch.int64, device=device),
        gen=torch.Generator().manual_seed(cfg.seed),
        noise_gen=torch.Generator(device=device).manual_seed(cfg.seed + 1))


def init_state(cfg: TrainConfig, device=None,
               dtype=torch.float32) -> TrainState:
    """A fresh state: weights from a generator seeded ``cfg.seed``, zero
    moments, on ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    model = M.TIPModel(cfg.model, device=device, dtype=dtype,
                       generator=torch.Generator().manual_seed(cfg.seed))
    zeros = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    return _state(cfg, model, zeros,
                  {k: torch.zeros_like(v) for k, v in zeros.items()}, 0,
                  device)


def train_state_from_jax(params, count, mu, nu, cfg: TrainConfig,
                         device=None, dtype=None) -> TrainState:
    """tip_tpu's params and Adam state (``count``, ``mu``, ``nu``: param
    pytrees of numpy arrays) -> a port state that continues that run. The
    step is Adam's count; the generators start from ``cfg.seed``."""
    device = resolve_device(device)
    sd = M.params_from_jax(params)
    dtype = next(iter(sd.values())).dtype if dtype is None else dtype
    model = M.TIPModel(cfg.model, device=device, dtype=dtype)
    model.load_state_dict(sd)

    def moments(tree):
        return {k: v.to(device=device, dtype=dtype)
                for k, v in M.params_from_jax(tree).items()}

    return _state(cfg, model, moments(mu), moments(nu), int(count), device)


def loss_fn(model, x_imu, x_s, y, noise, seeds, cfg: TrainConfig,
            mesh=None):
    """Composite loss on one batch: the training forward of ``x_s + noise``
    with dropout drawn by ``seeds`` (the model's ``train_forward``; None:
    off), then jerk + pose and root velocity + SBP. Under ``mesh`` the
    inputs are this rank's rows and the loss is the global batch's."""
    y_pred = model.train_forward(x_imu, x_s + noise, seeds, mesh)
    psum = mesh_lib.data_sum(mesh)
    nc = cfg.n_sbps * 4
    l_jerk = L.loss_jerk(y_pred[:, :, :-3 - nc], psum)
    yp = y_pred.reshape(-1, y_pred.shape[-1])
    yt = y.reshape(-1, y.shape[-1])
    l_q = L.loss_q_only_2axis(yt[:, :-nc], yp[:, :-nc], psum)
    l_c = L.loss_constr_multi(yt[:, -nc:], yp[:, -nc:], cfg.n_sbps, psum)
    total = l_q + l_c + l_jerk
    return total, {"loss": total, "loss_q": l_q, "loss_c": l_c,
                   "loss_jerk": l_jerk}


def draw_seeds(state: TrainState):
    """What draws this step's dropout masks: under ``dropout_impl="hash"``
    (seed0, layer_seeds) as int32 values from the state's CPU generator;
    under "rng" the state's device generator itself."""
    if state.model.cfg.dropout_impl == "rng":
        return state.noise_gen
    s = torch.randint(-2 ** 31, 2 ** 31, (1 + state.model.cfg.tf_layers,),
                      generator=state.gen, dtype=torch.int64).tolist()
    return s[0], s[1:]


def draw_noise(state: TrainState, x_s, cfg: TrainConfig):
    """History noise, uniform in [-noise, noise), from the device
    generator."""
    u = torch.rand(x_s.shape, generator=state.noise_gen, dtype=x_s.dtype,
                   device=x_s.device)
    return (u - 0.5) * (2.0 * cfg.noise_input_hist)


def _draw_noise(state: TrainState, x_s, cfg: TrainConfig, mesh):
    """``draw_noise`` for x_s; under ``mesh`` x_s is this rank's rows, the
    draw is the global batch's and the rank takes its rows."""
    if mesh is None:
        return draw_noise(state, x_s, cfg)
    n = x_s.shape[0] * mesh.size(0)
    whole = x_s.new_empty((n,) + tuple(x_s.shape[1:]))
    return draw_noise(state, whole, cfg)[mesh_lib.rows(mesh, n)]


AUX = ("loss", "loss_q", "loss_c", "loss_jerk", "grad_norm", "lr",
       "skipped")


def _grads(state: TrainState, batch, cfg: TrainConfig, noise, seeds,
           mesh=None):
    """The loss and the gradients of one batch, on the device with no host
    sync: (names, parameters, gradients, the aux of ``AUX`` as one float64
    tensor, whether the loss is finite as a () bool tensor). Under
    ``mesh`` the loss, the gradients of this rank's parameters and their
    norm are the global step's, the same on every rank, so a non-finite
    loss on one rank's rows is not finite on any."""
    x_imu, x_s, y = batch
    model = state.model
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    total, aux = loss_fn(model, x_imu, x_s, y, noise, seeds, cfg, mesh)
    total.backward()
    names = list(params)
    grads = [params[k].grad for k in names]
    if mesh is not None and mesh.size(0) > 1:
        mesh_lib.all_sum_(grads, mesh.get_group(mesh_lib.DATA_AXIS))
    g_norm = mesh_lib.global_norm(grads, names, mesh)
    ok = torch.isfinite(total)
    with torch.no_grad():
        vals = torch.stack([aux["loss"], aux["loss_q"], aux["loss_c"],
                            aux["loss_jerk"], g_norm]).to(torch.float64)
        vals = torch.cat([vals, torch.stack([lr_schedule(cfg)(state.step),
                                             (~ok).to(torch.float64)])])
    return names, params, grads, g_norm, vals, ok


def _apply(state: TrainState, names, params, grads, g_norm, lr,
           cfg: TrainConfig, ok=None):
    """Clip, Adam(W) and the parameter update with optax's formulas, on the
    device with no host sync. ``ok`` (a () bool tensor, or None: apply):
    where it is False the parameters, the moments and the step stay as
    they were (an exact select, so a kept update is bit for bit the
    unguarded one)."""
    with torch.no_grad():
        if cfg.clip > 0:
            trig = g_norm < cfg.clip
            one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
            grads = torch._foreach_mul(
                torch._foreach_div(grads, torch.where(trig, one, g_norm)),
                torch.where(trig, one, one * cfg.clip))
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        new_mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - B1),
                                    torch._foreach_mul(mu, B1))
        g2 = torch._foreach_mul(grads, grads)
        new_nu = torch._foreach_add(torch._foreach_mul(g2, 1.0 - B2),
                                    torch._foreach_mul(nu, B2))
        # the bias corrections and lr in float64 on the device, each
        # rounded to the moments' dtype as a Python float would be
        c = (state.step + 1).to(torch.float64)
        dt = new_mu[0].dtype
        m_hat = torch._foreach_div(new_mu, (1.0 - torch.pow(B1, c)).to(dt))
        v_hat = torch._foreach_div(new_nu, (1.0 - torch.pow(B2, c)).to(dt))
        u = torch._foreach_div(m_hat, torch._foreach_add(
            torch._foreach_sqrt(v_hat), EPS))
        plist = [params[k] for k in names]
        if cfg.optimizer == "AdamW":
            u = torch._foreach_add(u, torch._foreach_mul(plist,
                                                         cfg.weight_decay))
        delta = torch._foreach_mul(u, (-lr).to(dt))
        if ok is None:
            torch._foreach_add_(plist, delta)
            state.mu.update(zip(names, new_mu))
            state.nu.update(zip(names, new_nu))
            state.step = state.step + 1
        else:
            for k, p, d, m, v in zip(names, plist, delta, new_mu, new_nu):
                p.copy_(torch.where(ok, p + d, p))
                state.mu[k] = torch.where(ok, m, state.mu[k])
                state.nu[k] = torch.where(ok, v, state.nu[k])
            state.step = torch.where(ok, state.step + 1, state.step)
        for p in plist:
            p.grad = None


def train_step(state: TrainState, batch, cfg: TrainConfig, noise=None,
               seeds=None, mesh=None):
    """One update on ``batch`` = (x_imu, x_s, y) tensors on the model's
    device. ``noise`` and ``seeds`` (``draw_seeds``) default to draws from
    the state's generators, seeds first. Returns tip_tpu's aux as floats:
    loss, loss_q, loss_c, loss_jerk, the pre-clip grad_norm, lr at the step
    before the update, and ``skipped``: one host sync, after the backward.
    A step whose loss is not finite changes nothing: not the parameters,
    the moments, the step or the generators.

    mesh: every rank of the mesh calls with its rows of the global batch
    (``parallel.mesh.rows``), and of the noise where it is given, and a
    state that ``shard_state`` split for this mesh. The aux is the global
    step's on every rank.
    """
    rng_states = (state.gen.get_state(), state.noise_gen.get_state())
    if seeds is None:
        seeds = draw_seeds(state)
    if noise is None:
        noise = _draw_noise(state, batch[1], cfg, mesh)
    names, params, grads, g_norm, vals, _ = _grads(state, batch, cfg, noise,
                                                   seeds, mesh)
    out = dict(zip(AUX, vals.tolist()))
    out["skipped"] = not math.isfinite(out["loss"])
    if out["skipped"]:
        state.gen.set_state(rng_states[0])
        state.noise_gen.set_state(rng_states[1])
        for p in params.values():
            p.grad = None
        return out
    _apply(state, names, params, grads, g_norm, vals[AUX.index("lr")], cfg)
    return out


def make_epoch_fn(cfg: TrainConfig, device_data, sampler=None,
                  n_batches: Optional[int] = None, mesh=None):
    """Whole-epoch training (twin of tip_tpu's ``make_epoch_fn``): the train
    step over each row of an epoch's (n_batches, B) window ends, the
    windows gathered on the device from ``device_data``
    (``data.device_gather``), with no host sync from the first batch to the
    last. The non-finite guard runs on the device: a batch whose loss is
    not finite keeps the parameters, Adam's moments and the step (the
    generators advance, as tip_tpu's ``kept`` state's rng does) and is
    reported in ``skipped``.

    Returns epoch_fn(state, ends) -> (state, aux): the state is updated in
    place and returned; aux maps each name of ``AUX`` to an (n_batches,)
    float64 tensor on the device, to be read once an epoch. ``ends``: an
    (n_batches, B) integer tensor (copied to the state's device first if
    it is not there: a host sync before the epoch).

    sampler: a ``data.WindowSampler`` (with n_batches). The epoch's ends
    are then drawn on the device from the state's device generator before
    the first batch (``data.device_sample_epoch``), and the function is
    epoch_fn(state) -> (state, aux): the schedule is a pure function of
    the checkpointed state.

    mesh: every rank runs the epoch on a state that ``shard_state`` split,
    with the whole ``ends`` (or draws them whole) and gathers its columns'
    windows; the guard's ``ok`` is the global loss's, so every rank keeps
    or drops a batch alike.
    """
    if sampler is not None and n_batches is None:
        raise ValueError("a sampler needs n_batches")

    def run(state, ends):
        dev = state.step.device
        ends = torch.as_tensor(ends, device=dev)
        if mesh is not None:
            ends = ends[:, mesh_lib.rows(mesh, ends.shape[1])]
        rows = []
        for i in range(ends.shape[0]):
            batch = data_lib.device_gather(device_data, ends[i], cfg.seq_len)
            seeds = draw_seeds(state)
            noise = _draw_noise(state, batch[1], cfg, mesh)
            names, params, grads, g_norm, vals, ok = _grads(
                state, batch, cfg, noise, seeds, mesh)
            _apply(state, names, params, grads, g_norm,
                   vals[AUX.index("lr")], cfg, ok=ok)
            rows.append(vals)
        table = (torch.stack(rows) if rows else
                 torch.zeros((0, len(AUX)), dtype=torch.float64, device=dev))
        return state, {k: table[:, j] for j, k in enumerate(AUX)}

    if sampler is None:
        return run

    def epoch_sampled(state):
        ends = data_lib.device_sample_epoch(sampler, state.noise_gen,
                                            n_batches, cfg.batch_size)
        return run(state, ends)

    return epoch_sampled


# ---------------------------------------------------------------------------
# the mesh: this rank's part of the state
# ---------------------------------------------------------------------------

def _mesh_safe(cfg: M.ModelConfig, mesh) -> M.ModelConfig:
    """The model configuration a mesh trains (tip_tpu's ``_mesh_safe``):
    the encoder in the xla loop, since K11/K12's per-layer hash masks are
    not the loop's, which tip_tpu trains under any mesh, and tensor
    parallelism splits the layer that K11 fuses. The RNN keeps its kernels
    (K1 and K10 on every rank): its rows are independent and W_hh is
    replicated. tip_tpu swaps its Pallas RNN for the scan only because
    ``pallas_call`` has no partitioning rule."""
    if mesh is None or cfg.encoder_impl == "xla":
        return cfg
    return dataclasses.replace(cfg, encoder_impl="xla")


def shard_state(state: TrainState, mesh) -> TrainState:
    """This rank's part of a whole state, in place (tip_tpu's
    ``shard_state``): the parameters split as
    ``parallel.mesh.param_shardings`` places them, Adam's moments as their
    parameter, the step and the generators replicated (every rank made the
    same), and the model set to the configuration a mesh trains
    (``_mesh_safe``). A model axis must divide the heads and the FF width,
    so that each rank owns whole heads; else ValueError."""
    cfg = state.model.cfg
    n_model = mesh.size(1)
    bad = [f"{k}={v}" for k, v in (("n_heads", cfg.n_heads),
                                    ("tf_hid_size", cfg.tf_hid_size))
           if v % n_model]
    if bad:
        raise ValueError(f"a model axis of {n_model} ranks must divide "
                         f"n_heads and tf_hid_size; the model has "
                         f"{', '.join(bad)}")
    params = dict(state.model.named_parameters())
    for name, pl in mesh_lib.param_shardings(mesh, params).items():
        if not mesh_lib.is_sharded(pl):
            continue
        owner, _, attr = name.rpartition(".")
        setattr(state.model.get_submodule(owner), attr, torch.nn.Parameter(
            mesh_lib.shard(params[name].detach(), pl, mesh)))
        state.mu[name] = mesh_lib.shard(state.mu[name], pl, mesh)
        state.nu[name] = mesh_lib.shard(state.nu[name], pl, mesh)
    state.model.cfg = _mesh_safe(cfg, mesh)
    return state


def gather_state(state: TrainState, mesh):
    """The whole parameters and moments of a state that ``shard_state``
    split, by name, on every rank (exact: ``parallel.mesh.gather``);
    a collective, which every rank calls. Returns (params, mu, nu)."""
    params = {k: v.detach() for k, v in state.model.named_parameters()}
    names = list(params)
    placed = mesh_lib.param_shardings(mesh, names)
    whole = mesh_lib.gather(
        [params[k] for k in names] + [state.mu[k] for k in names]
        + [state.nu[k] for k in names], [placed[k] for k in names] * 3,
        mesh)
    n = len(names)
    return tuple(dict(zip(names, whole[i * n:(i + 1) * n]))
                 for i in range(3))


def _is_rank0(mesh) -> bool:
    return mesh is None or torch.distributed.get_rank() == 0


# ---------------------------------------------------------------------------
# checkpoints: parameters, moments, step and generators, resume-exact
# ---------------------------------------------------------------------------

def _ckpt_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := _CKPT.match(f)))


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    max_to_keep: int = 4, mesh=None):
    """Write the full state as ``<ckpt_dir>/ckpt_<step>.pt`` and keep only
    the newest ``max_to_keep`` checkpoints. Under ``mesh`` every rank calls
    it: the parts are gathered, and rank 0 writes what one device would."""
    params = {k: v.detach() for k, v in state.model.state_dict().items()}
    mu, nu = state.mu, state.nu
    if mesh is not None:
        params, mu, nu = gather_state(state, mesh)
        if not _is_rank0(mesh):
            return
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    tmp = path + ".tmp"
    torch.save({"params": params, "mu": mu, "nu": nu,
                "step": int(state.step),
                "gen": state.gen.get_state(),
                "noise_gen": state.noise_gen.get_state(),
                "compute_dtype": state.model.cfg.compute_dtype}, tmp)
    os.replace(tmp, path)
    for old in _ckpt_steps(ckpt_dir)[:-max_to_keep]:
        os.remove(os.path.join(ckpt_dir, f"ckpt_{old}.pt"))


def restore_checkpoint(ckpt_dir: str, cfg: TrainConfig,
                       step: Optional[int] = None, params_only: bool = False,
                       device=None, mesh=None) -> TrainState:
    """``_restore`` the whole state, then, under ``mesh``, this rank's part
    of it (``shard_state``): checkpoints hold no mesh, so a run under one
    resumes on one device and the other way round."""
    state = _restore(ckpt_dir, cfg, step, params_only, device)
    return state if mesh is None else shard_state(state, mesh)


def _restore(ckpt_dir: str, cfg: TrainConfig, step: Optional[int],
             params_only: bool, device) -> TrainState:
    """The state saved at ``step`` (None: the newest) in a checkpoint
    directory of this package (``ckpt_<step>.pt``) or in tip_tpu's orbax
    checkpoint (a step directory, or a manager's directory of numbered
    steps: ``_restore_orbax``). Where one directory holds both (a run of
    this package resumed from tip_tpu's), the newest step is taken, this
    package's on a tie. The parameters must match the model config (names
    and shapes); else ValueError. ``params_only``: the parameters, step and
    generators with fresh moments (a warm start). A ``.pt`` checkpoint
    records the compute dtype it was trained in, which a full resume
    requires to be ``cfg.model.compute_dtype``."""
    device = resolve_device(device)
    steps = _ckpt_steps(ckpt_dir)
    if orbax_read.is_orbax_dir(ckpt_dir):
        newest = orbax_read.latest_step(ckpt_dir)
        if (not steps or (step is None and newest is not None
                          and newest > steps[-1])
                or (step is not None and step not in steps)):
            return _restore_orbax(ckpt_dir, cfg, step, params_only, device)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step = steps[-1] if step is None else step
    ck = torch.load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"),
                    map_location="cpu", weights_only=True)
    state = init_state(cfg, device, dtype=ck["params"]["out.w"].dtype)
    want = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in ck["params"].items()}
    if want != got:
        bad = sorted(set(want.items()) ^ set(got.items()))[:5]
        raise ValueError(f"checkpoint at {ckpt_dir} does not match the "
                         f"model config (check size_s / with_acc_sum / "
                         f"widths): {bad}")
    saved = ck.get("compute_dtype")
    if not params_only and saved != cfg.model.compute_dtype:
        raise ValueError(f"checkpoint at {ckpt_dir} was trained in "
                         f"compute_dtype={saved!r}, the model config says "
                         f"{cfg.model.compute_dtype!r}")
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            p.copy_(ck["params"][k])
    if not params_only:
        state.mu = {k: v.to(device) for k, v in ck["mu"].items()}
        state.nu = {k: v.to(device) for k, v in ck["nu"].items()}
    state.step = torch.tensor(int(ck["step"]), dtype=torch.int64,
                              device=device)
    state.gen.set_state(ck["gen"])
    state.noise_gen.set_state(ck["noise_gen"])
    return state


def orbax_adam_prefix(cfg: TrainConfig) -> str:
    """The name under which tip_tpu's optimizer state for ``cfg`` keeps
    Adam's count, mu and nu: ``chain([clip_by_global_norm,] adam|adamw)``,
    adam(w) itself a chain whose first state is scale_by_adam's
    (tip_tpu/train/train.py ``make_optimizer``)."""
    return ("opt_state.1" if cfg.clip > 0 else "opt_state.0") + ".0"


def orbax_optimizer_names(cfg: TrainConfig, param_names) -> set:
    """The array names of the optimizer state tip_tpu keeps for ``cfg``:
    Adam's count, mu and nu and the count of the schedule that ends the
    inner chain (``scale_by_adam, [add_decayed_weights,]
    scale_by_schedule``). Empty states hold no array."""
    adam = orbax_adam_prefix(cfg)
    sched = 2 if cfg.optimizer == "AdamW" else 1
    return ({f"{adam}.count", f"{adam[:-1]}{sched}.count"}
            | {f"{adam}.{m}.{p}" for m in ("mu", "nu")
               for p in param_names})


def seed_generators(state: TrainState, rng) -> None:
    """Seeds the state's generators from tip_tpu's threefry key (two
    uint32): with s = (key[0] << 32) | key[1], the CPU generator from s and
    the device generator from (s + 1) mod 2^64. Two restores of one
    checkpoint then draw the same masks and noise; the draws are torch's,
    not jax.random's."""
    key = np.asarray(rng, dtype=np.uint64).reshape(-1)
    if key.shape != (2,):
        raise ValueError(f"rng: expected tip_tpu's key of two uint32, got "
                         f"shape {key.shape}")
    s = (int(key[0]) << 32) | int(key[1])
    state.gen.manual_seed(s)
    state.noise_gen.manual_seed((s + 1) % 2 ** 64)


def _restore_orbax(ckpt_dir, cfg: TrainConfig, step, params_only,
                   device) -> TrainState:
    """tip_tpu's orbax checkpoint (tip_tpu/train/train.py
    ``restore_checkpoint``) -> a port state, read with
    ``utils.orbax_read`` (no orbax, no tensorstore). ``params.*`` become the
    model's parameters (float32 as stored, whatever ``compute_dtype``
    says); Adam's ``mu``, ``nu`` and ``count``, under the name the chain of
    ``cfg.optimizer`` and ``cfg.clip`` gives them (``orbax_adam_prefix``),
    the moments; ``step`` the step, which a full resume
    requires to equal Adam's count (the port keeps one counter);
    ``rng`` seeds the generators (``seed_generators``).

    Errors, in tip_tpu's words: the old packed ``w_qkv`` layout, another
    parameter structure, parameter shapes that do not match, and for a full
    resume an optimizer state other than ``cfg.optimizer`` and ``cfg.clip``
    make; ``params_only`` accepts another optimizer state with a warning
    and restores the parameters, step and generators with fresh moments.
    """
    arrays = orbax_read.read_orbax(orbax_read.step_dir(ckpt_dir, step))
    params = {k[len("params."):]: v for k, v in arrays.items()
              if k.startswith("params.")}
    if any("w_qkv" in k for k in params):
        raise ValueError(
            f"checkpoint at {ckpt_dir} uses the old packed-qkv parameter "
            f"layout; current checkpoints store q/k/v separately (head-clean "
            f"tensor parallelism). Re-export the weights or retrain.")
    state = init_state(cfg, device, dtype=torch.float32)
    want = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
    if set(params) != set(want):
        diff = sorted(set(params) ^ set(want))[:5]
        raise ValueError(
            f"checkpoint at {ckpt_dir} stores a different PARAMETER "
            f"structure than the model config — check "
            f"tf_layers/with_rnn/size_s. Differing names: {diff}")
    opt = {k for k in arrays if k.startswith("opt_state.")}
    opt_ok = opt == orbax_optimizer_names(cfg, want)
    if not opt_ok and not params_only:
        raise ValueError(
            f"checkpoint at {ckpt_dir} stores a different optimizer-state "
            f"structure than TrainConfig(optimizer={cfg.optimizer!r}, "
            f"clip={cfg.clip}); resume with that config, or restore with "
            f"params_only=True")
    shape_mism = [f"params.{k}: checkpoint {tuple(params[k].shape)} vs "
                  f"model {want[k]}" for k in sorted(want)
                  if tuple(params[k].shape) != want[k]]
    if shape_mism and opt_ok:
        raise ValueError(
            f"checkpoint at {ckpt_dir} does not match the model config "
            f"(size_s={cfg.model.size_s}, with_acc_sum="
            f"{cfg.model.with_acc_sum}) — check the --five_sbp / "
            f"--with_acc_sum flags used at training time. Mismatches: "
            + "; ".join(shape_mism[:5]))
    if shape_mism:
        raise ValueError(
            f"checkpoint at {ckpt_dir} stores parameters whose SHAPES do not "
            f"match the model config — check size_s/tf_in_dim/rnn_nhid "
            f"flags. Mismatches: " + "; ".join(shape_mism[:5]))
    if not opt_ok:
        warnings.warn(
            f"checkpoint at {ckpt_dir} stores a different optimizer-state "
            f"structure than TrainConfig(optimizer={cfg.optimizer!r}); "
            f"restoring params/step/rng only (fresh optimizer state).",
            stacklevel=4)
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            p.copy_(torch.from_numpy(params[k]))
    n_step = int(arrays["step"])
    if not params_only:
        adam = orbax_adam_prefix(cfg)
        count = int(arrays[f"{adam}.count"])
        if count != n_step:
            raise ValueError(
                f"checkpoint at {ckpt_dir}: step {n_step} but Adam's count "
                f"{count}; the port keeps one counter for both")
        for m, dst in (("mu", state.mu), ("nu", state.nu)):
            for k in want:
                dst[k] = torch.from_numpy(arrays[f"{adam}.{m}.{k}"]).to(
                    device=device, dtype=torch.float32)
    state.step = torch.tensor(n_step, dtype=torch.int64, device=device)
    seed_generators(state, arrays["rng"])
    return state


def train_loop(cfg: TrainConfig, dataset, *, mesh=None, ckpt_dir=None,
               log_fn=print, max_epochs: Optional[int] = None,
               warm_start: Optional[str] = None,
               metrics_path: Optional[str] = None,
               device=None) -> TrainState:
    """The training loop (tip_tpu's ``train_loop``): per epoch fresh
    windows, one ``train_step`` per full batch, a log record every
    ``cfg.log_interval`` steps and per epoch, a checkpoint after epoch 1,
    every 10th and the last. A step with a non-finite loss is skipped and
    logged; more than 20 raise. The blobs go to the device once and each
    batch's windows are gathered there (``data.device_gather``).

    dataset: ``data.PackedDataset``. The run starts from
    ``init_state(cfg, device)``; warm_start: a checkpoint directory of
    this package, tip_tpu's orbax checkpoint or a reference ``.pt`` state
    dict, weights only.
    metrics_path: jsonl file receiving every record.
    mesh: every rank of the mesh runs the loop alike, with the whole blobs
    on its device (``device``: this rank's); each takes its rows of every
    batch (``train_step``), and only rank 0 logs and writes files.
    """
    state = init_state(cfg, device)
    device = state.model.out.w.device
    if not _is_rank0(mesh):
        metrics_path = None

        def log_fn(record):
            pass
    writer = None
    if metrics_path is not None:
        from tip_tpu_torch.utils.observability import MetricsWriter
        writer = MetricsWriter(metrics_path)
        console_log = log_fn

        def log_fn(record):
            writer.write(**record)
            console_log(record)

    try:
        if warm_start:
            if warm_start.endswith(".pt"):
                sd = M.params_from_torch_state_dict(
                    torch.load(warm_start, map_location="cpu"), cfg.model)
            else:
                sd = restore_checkpoint(warm_start, cfg, params_only=True,
                                        device=device).model.state_dict()
            with torch.no_grad():
                for k, p in state.model.named_parameters():
                    p.copy_(sd[k])
        if mesh is not None:
            shard_state(state, mesh)
        dds = data_lib.to_device(dataset, device)
        np_rng = np.random.default_rng(cfg.seed)
        epochs = max_epochs if max_epochs is not None else cfg.epochs
        bad_steps = 0
        for ep in range(1, epochs + 1):
            idx = data_lib.sample_epoch_indices(dataset.info, cfg.seq_len,
                                                np_rng)
            idx = torch.as_tensor(idx, dtype=torch.int64).to(device)
            running = []
            for bi in range(len(idx) // cfg.batch_size):
                ends = idx[bi * cfg.batch_size:(bi + 1) * cfg.batch_size]
                if mesh is not None:
                    ends = ends[mesh_lib.rows(mesh, cfg.batch_size)]
                aux = train_step(state, data_lib.device_gather(
                    dds, ends, cfg.seq_len), cfg, mesh=mesh)
                if aux["skipped"]:
                    bad_steps += 1
                    log_fn({"epoch": ep, "batch": bi + 1,
                            "event": "non_finite_loss_skipped",
                            "bad_steps": bad_steps})
                    if bad_steps > MAX_BAD_STEPS:
                        raise FloatingPointError(
                            f"training diverged: >{MAX_BAD_STEPS} non-finite "
                            f"losses")
                    continue
                running.append(aux["loss"])
                if (bi + 1) % cfg.log_interval == 0:
                    log_fn({"epoch": ep, "batch": bi + 1,
                            "loss": float(np.mean(
                                running[-cfg.log_interval:])),
                            "lr": aux["lr"], "grad_norm": aux["grad_norm"]})
            if ckpt_dir and (ep == 1 or ep % 10 == 0):
                save_checkpoint(ckpt_dir, state, ep, mesh=mesh)
            log_fn({"epoch": ep, "mean_loss": float(np.mean(running))
                    if running else None})
        if ckpt_dir:
            save_checkpoint(ckpt_dir, state, epochs, mesh=mesh)
    finally:
        if writer is not None:
            writer.close()
    return state
