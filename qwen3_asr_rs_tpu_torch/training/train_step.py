"""ASR fine-tuning: the training step.

Port of ``qwen3_asr_rs_tpu/training/train_step.py``. A step computes the
causal-LM cross-entropy of the decoder over (audio, transcript) pairs,
with the encoder's audio embeddings injected into the prompt exactly as
at inference time, differentiates it with autograd and applies a
``torch.optim`` update. No kernel lies on this path: attention is dense
at training sizes and the float linears are plain products (the kernels
that would be reached raise, ``ops/kernels.forbid_backward``).

The state is PyTorch's: ``TrainState`` holds the parameter tree (leaf
tensors with ``requires_grad``), the optimizer bound to those leaves, and
the step count, and a step updates the tensors in place. Optimizers are
given as factories (``sgd``, ``adamw``: optax's defaults), called on the
leaves.

Tied embeddings: JAX's tree holds the same array as ``embed`` and
``lm_head``, but ``jax.grad`` gives each leaf its own cotangent and optax
updates the two apart, so the head unties after the first step (and
JAX's export then writes ``embed`` only). ``TrainState.create`` copies
the behaviour: ``lm_head`` becomes its own tensor.

On a ('dp', 'tp') mesh (``make_train_step(mesh=)``, SPMD: every rank
runs the step) the state holds this rank's shards (``step.init`` cuts
them, ``parallel/sharding.py``: the decoder Megatron-sharded over tp, the
encoder too where its heads divide) and each rank takes its dp rows of
the batch (``data.dp_rows``, ``prefetch_to_device(mesh=)``). The loss is
JAX's masked mean over the whole batch, Σ(nll·mask) / max(Σmask, 1): the
mask's sum is all-reduced over dp before the division and the gradients
after the backward (each rank's mean, as DDP averages, would weigh the
ranks' tokens unequally whenever their masks differ). The tp collectives
are the models' autograd operators (``parallel/comm.py``). The optimizer
then takes the same gradients on every dp rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AsrConfig
from ..models.audio_encoder import AudioEncoder
from ..models.decoders import require
from ..models.text_decoder import TextDecoder
from ..parallel.comm import all_reduce, mesh_axis
from ..parallel.mesh import mesh_dims
from ..parallel.sharding import model_param_specs, shard_params
from ..runtime.prompt import AUDIO_OFFSET

Tree = Any
OptimizerFactory = Callable[[list], torch.optim.Optimizer]


def sgd(lr: float) -> OptimizerFactory:
    """``optax.sgd(lr)``: plain SGD, no momentum."""
    return functools.partial(torch.optim.SGD, lr=lr)


def adamw(lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFactory:
    """``optax.adamw(lr)`` with optax's defaults (weight decay 1e-4, not
    torch's 1e-2), decaying every leaf as optax does without a mask."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=betas, eps=eps,
                             weight_decay=weight_decay)


def tree_leaves(tree: Tree) -> list:
    """Leaves in sorted-key order (``jax.tree_util.tree_leaves``' order):
    the optimizer's parameter order, which its state dict indexes."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _trainable_copy(tree: Tree) -> Tree:
    """Every leaf copied into its own tensor (a tied ``lm_head`` too),
    float leaves with ``requires_grad``."""
    if isinstance(tree, dict):
        return {k: _trainable_copy(v) for k, v in tree.items()}
    t = tree.detach().clone()
    return t.requires_grad_(t.is_floating_point())


@dataclasses.dataclass
class TrainState:
    params: Tree                      # {"encoder": ..., "decoder": ...}
    optimizer: torch.optim.Optimizer  # bound to tree_leaves(params)
    step: int
    # on a mesh: the mesh and the spec tree that cut ``params`` into this
    # rank's pieces (checkpoints gather and cut by them)
    mesh: Any = None
    specs: Tree = None

    @classmethod
    def create(cls, params: Tree, optimizer: OptimizerFactory,
               step: int = 0, mesh=None, specs: Tree = None) -> "TrainState":
        """A state over copies of ``params`` (each leaf its own tensor,
        so a tied lm_head trains apart from embed, as in JAX) and a fresh
        optimizer from the factory."""
        params = _trainable_copy(params)
        return cls(params=params,
                   optimizer=optimizer(tree_leaves(params)), step=step,
                   mesh=mesh, specs=specs)


def batch_to_device(batch: dict, device) -> dict:
    """numpy arrays or tensors -> tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def asr_loss(
    config: AsrConfig,
    encoder: AudioEncoder,
    decoder: TextDecoder,
    params: Tree,
    batch: dict,
    remat: bool = True,
):
    """Causal-LM cross entropy over transcript tokens (0-d float32).

    batch (tensors on the parameters' device):
      mel:        (B, num_mel_bins, F) log-mel, padded frames == 0
      n_frames:   (B,) int true frame counts
      n_audio:    (B,) int valid audio-token counts
      token_ids:  (B, P) int full sequence (prompt + transcript + pad)
      loss_mask:  (B, P) float, 1.0 on positions whose NEXT token is a
                  transcript target
    """
    nll, count = masked_nll(config, encoder, decoder, params, batch, remat)
    return nll / torch.clamp(count, min=1.0)


def masked_nll(config: AsrConfig, encoder: AudioEncoder,
               decoder: TextDecoder, params: Tree, batch: dict,
               remat: bool = True):
    """(Σ nll · mask, Σ mask) of a batch: ``asr_loss``'s numerator and
    denominator, which a dp step sums over its ranks."""
    enc_p, dec_p = params["encoder"], params["decoder"]
    token_ids = batch["token_ids"].long()
    b, p = token_ids.shape

    flat, _ = encoder.batch(enc_p, batch["mel"], batch["n_frames"])

    tok_embeds = decoder.embed(dec_p, token_ids)  # (B, P, H)
    n_copy = min(flat.shape[1], p - AUDIO_OFFSET)
    shifted = F.pad(flat[:, :n_copy].to(tok_embeds.dtype),
                    (0, 0, AUDIO_OFFSET, p - AUDIO_OFFSET - n_copy))
    pos = torch.arange(p, device=token_ids.device)
    n_audio = batch["n_audio"].to(token_ids.device)
    is_audio = (pos[None, :] >= AUDIO_OFFSET) & (
        pos[None, :] < AUDIO_OFFSET + n_audio[:, None])
    hidden = torch.where(is_audio[..., None], shifted, tok_embeds)

    logits = decoder.forward_full(dec_p, hidden, pos, remat=remat)  # f32

    targets = torch.roll(token_ids, -1, dims=1)
    mask = batch["loss_mask"].float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def make_train_step(
    config: AsrConfig,
    optimizer: OptimizerFactory,
    max_position: int = 8192,
    remat: bool = True,
    device: str | torch.device = "cuda",
    mesh=None,
) -> Callable:
    """The train step ``step(state, batch) -> (state, loss)``: the loss
    and its gradient at ``state.params``, then one update by
    ``state.optimizer``; the state's tensors change in place and the
    returned state (step + 1) shares them. ``loss`` is the 0-d loss
    before the update. The batch holds numpy arrays or tensors; it is
    moved to ``device``. ``step.init(params)`` builds a state with
    ``optimizer`` (the factory), as ``optimizer.init`` does in JAX.

    ``remat`` (default on) checkpoints each decoder and encoder layer:
    the backward recomputes layer activations instead of keeping every
    layer's.

    ``mesh``: a ('dp', 'tp') DeviceMesh (see the module docstring);
    ``step.init`` then takes the whole parameter tree and keeps this
    rank's shards (the state keeps the mesh and the spec tree), and a
    step takes this rank's dp rows and returns the
    whole batch's loss.
    """
    require(config.text, "training")
    device = torch.device(device)
    dp, tp = mesh_axis(mesh, "dp"), mesh_axis(mesh, "tp")
    encoder = AudioEncoder(config.audio, device=device, remat=remat, tp=tp)
    decoder = TextDecoder(config.text, max_position=max_position,
                          device=device, tp=tp)

    def train_step(state: TrainState, batch: dict):
        batch = batch_to_device(batch, device)
        state.optimizer.zero_grad(set_to_none=True)
        nll, count = masked_nll(config, encoder, decoder, state.params,
                                batch, remat=remat)
        if dp is not None:
            count = all_reduce(count.detach().clone(), dp)
        loss = nll / torch.clamp(count, min=1.0)
        loss.backward()
        loss = loss.detach()
        if dp is not None:
            for leaf in tree_leaves(state.params):
                if leaf.grad is not None:
                    all_reduce(leaf.grad, dp)
            loss = all_reduce(loss.clone(), dp)
        state.optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), loss

    def init(params: Tree) -> TrainState:
        if mesh is None:
            return TrainState.create(params, optimizer)
        specs = model_param_specs(config.audio.encoder_attention_heads,
                                  mesh_dims(mesh)[1])
        return TrainState.create(shard_params(params, mesh, specs),
                                 optimizer, mesh=mesh, specs=specs)

    train_step.init = init
    return train_step
