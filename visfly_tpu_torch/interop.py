"""Carry the JAX package's state into this package's objects.

Each function takes the JAX objects after ``np.asarray`` on every leaf
(``jax.tree_util.tree_map(np.asarray, x)``), i.e. the same NamedTuples
holding numpy arrays, so both packages can compute from identical
parameters, scenes and states. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .core.types import Bound
from .algos.buffers import ReplayBuffer
from .algos.ppo import EpisodeStats
from .dynamics.config import DroneParams
from .dynamics.dynamics import DynState
from .envs.base import CollisionInfo, EnvState
from .envs.catch import BallState
from .envs.landing import LandingAux
from .envs.racing import RacingAux
from .policies.autoencoder import DepthAutoencoder
from .policies.compact_backbones import EfficientNetV2, MobileNetV3
from .policies.extractors import (
    MLP,
    DecoderHead,
    GroupNorm,
    GRUCell,
    ImageCNN,
    ResNetCNN,
    TransCNN,
)
from .policies.torch_backbones import TorchResNet
from .policies.world_model import WorldModel
from .policies.networks import (
    Actor,
    ActorCriticPolicy,
    QCritic,
    RecurrentActor,
    RecurrentActorCriticPolicy,
    StateCritic,
)
from .render.sphere_trace import Lighting
from .render.trace_kernel import KernelScene
from .scene.objects import DynamicObjects, ObjectsState
from .scene.prim_scene import PrimitiveScene, scene_from_arrays
from .scene.scene import SceneData, scene_data_from_arrays

# env-specific aux states the port knows, by their field names
_AUX_TYPES = {cls._fields: cls for cls in (LandingAux, RacingAux, BallState)}


def _t(x, device, dtype=None) -> torch.Tensor:
    """A tensor holding a copy of ``x`` (JAX hands out read-only buffers);
    the dtype is kept unless given."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def drone_params_from_numpy(p, device=None) -> DroneParams:
    """``visfly_tpu.dynamics.DroneParams`` of numpy arrays → DroneParams."""
    fields = {f: _t(getattr(p, f), device) for f in DroneParams._fields
              if f != "thrust_bound"}
    bound = Bound(min=_t(p.thrust_bound.min, device), max=_t(p.thrust_bound.max, device))
    return DroneParams(thrust_bound=bound, **fields)


def dyn_state_from_numpy(s, device=None) -> DynState:
    """``visfly_tpu.dynamics.DynState`` of numpy arrays → DynState; the
    per-agent drag coefficients cross over where they are set."""
    def leaf(f):
        x = getattr(s, f, ())
        return () if isinstance(x, tuple) else _t(x, device)

    return DynState(**{f: leaf(f) for f in DynState._fields})


def scene_from_numpy(scene, device=None) -> PrimitiveScene:
    """``visfly_tpu.scene.PrimitiveScene`` of numpy arrays → PrimitiveScene."""
    arrays = {f: getattr(scene, f) for f in
              ("params", "colors", "semantic", "bbox", "boxes", "capsules")}
    return scene_from_arrays(arrays, float(scene.eps), device)


def scene_data_from_numpy(data, device=None) -> SceneData:
    """``visfly_tpu.scene.SceneData`` of numpy arrays (sdf, albedo, semantic,
    origin, spacing, bbox, and where present triangles and the texture
    tables tri_uv, tri_rect, atlas) → SceneData."""
    return scene_data_from_arrays({f: getattr(data, f, ()) for f in SceneData._fields}, device)


def kernel_scene_from_numpy(kscene, device=None) -> KernelScene:
    """``visfly_tpu.render.pallas_trace.KernelScene`` of numpy arrays →
    KernelScene."""
    return KernelScene(_t(kscene.boxes, device), _t(kscene.capsules, device))


def lighting_from_numpy(lighting, device=None) -> Optional[Lighting]:
    """The tuple ``visfly_tpu.render.sphere_trace.bake_lighting`` returns
    (numpy leaves, the ``shadows`` bool last), or None → Lighting or None."""
    if lighting is None:
        return None
    return Lighting(*(_t(x, device, torch.float32) for x in lighting[:5]),
                    shadows=bool(lighting[5]))


def aux_from_numpy(aux, device=None):
    """An env's ``EnvState.aux`` NamedTuple of numpy arrays → the port's
    NamedTuple of the same fields; ``()`` stays ``()``."""
    if isinstance(aux, tuple) and not hasattr(aux, "_fields"):
        if len(aux):
            raise NotImplementedError("only NamedTuple aux states cross over")
        return ()
    if aux._fields not in _AUX_TYPES:
        raise NotImplementedError(f"EnvState.aux of type {type(aux).__name__} (fields "
                                  f"{aux._fields}) has no counterpart in the port")
    return _AUX_TYPES[aux._fields](*(_t(x, device) for x in aux))


def dynamic_objects_from_numpy(objs, device=None) -> DynamicObjects:
    """``visfly_tpu.scene.objects.DynamicObjects`` of numpy arrays →
    DynamicObjects."""
    return DynamicObjects(
        table=_t(objs.table, device), period=_t(objs.period, device),
        radius=_t(objs.radius, device), scene_of=_t(objs.scene_of, device, torch.int64),
        mesh=None if objs.mesh is None else _t(objs.mesh, device))


def objects_state_from_numpy(objs, device=None):
    """``visfly_tpu.scene.objects.ObjectsState`` of numpy arrays →
    ObjectsState; ``()`` stays ``()``."""
    if isinstance(objs, tuple) and not hasattr(objs, "_fields"):
        return ()
    return ObjectsState(*(_t(x, device) for x in objs))


def env_state_from_numpy(st, gen: Optional[torch.Generator] = None,
                         device=None) -> EnvState:
    """``visfly_tpu.envs.EnvState`` of numpy arrays → EnvState. The JAX PRNG
    key has no counterpart; ``gen`` (default: a generator on ``device``
    seeded with 0) takes its place. ``aux`` crosses over for the envs the
    port has (``LandingAux``, ``RacingAux``, ``BallState``), and so do the
    dynamic objects' state and the world-model latents (deter, stoch)."""
    if gen is None:
        gen = torch.Generator(device=device or "cpu").manual_seed(0)
    c = st.collision
    return EnvState(
        dyn=dyn_state_from_numpy(st.dyn, device),
        gen=gen,
        step_count=_t(st.step_count, device, torch.int32),
        episode_done=_t(st.episode_done, device, torch.bool),
        success=_t(st.success, device, torch.bool),
        failure=_t(st.failure, device, torch.bool),
        collision=CollisionInfo(
            point=_t(c.point, device),
            vector=_t(c.vector, device),
            dis=_t(c.dis, device),
            is_collision=_t(c.is_collision, device, torch.bool),
            is_out_bounds=_t(c.is_out_bounds, device, torch.bool),
        ),
        once_collided=_t(st.once_collided, device, torch.bool),
        returns=_t(st.returns, device),
        aux=aux_from_numpy(getattr(st, "aux", ()), device),
        objects=objects_state_from_numpy(getattr(st, "objects", ()), device),
        latent=tuple(_t(x, device) for x in getattr(st, "latent", ())),
    )


# ---------------------------------------------------------------------------
# policies and trainers
# ---------------------------------------------------------------------------


def _load_dense(layer, p) -> None:
    """A flax ``Dense`` {kernel (in, out), bias} into an ``nn.Linear``."""
    layer.weight.copy_(_t(p["kernel"], layer.weight.device).T)
    if layer.bias is not None:
        layer.bias.copy_(_t(p["bias"], layer.bias.device))


def _load_mlp(mlp: MLP, p) -> None:
    for i, dense in enumerate(mlp.dense):
        _load_dense(dense, p[f"dense_{i}"])
    for i, norm in enumerate(mlp.norm or ()):
        norm.weight.copy_(_t(p[f"LayerNorm_{i}"]["scale"], norm.weight.device))
        norm.bias.copy_(_t(p[f"LayerNorm_{i}"]["bias"], norm.bias.device))


def _load_cnn(cnn: ImageCNN, p) -> None:
    for i, conv in enumerate(cnn.conv):  # HWIO → OIHW
        conv.weight.copy_(_t(p[f"conv_{i}"]["kernel"], conv.weight.device).permute(3, 2, 0, 1))
        conv.bias.copy_(_t(p[f"conv_{i}"]["bias"], conv.bias.device))
    # flax flattens NHWC, so proj's kernel rows run (H, W, C); here (C, H, W)
    c, h, w = cnn.feat_shape
    kernel = _t(p["proj"]["kernel"], cnn.proj.weight.device)
    cnn.proj.weight.copy_(kernel.reshape(h, w, c, -1).permute(3, 2, 0, 1).reshape(-1, c * h * w))
    cnn.proj.bias.copy_(_t(p["proj"]["bias"], cnn.proj.bias.device))


def _load_gru(gru: GRUCell, g) -> None:
    """A flax ``GRUCell``'s six gates {ir, iz, in, hr, hz, hn} into ``x_proj``
    [ir | iz | in], ``h_proj`` [hr | hz] and ``hn``."""
    dev = gru.hn.weight.device
    gru.x_proj.weight.copy_(torch.cat([_t(g[k]["kernel"], dev).T for k in ("ir", "iz", "in")]))
    gru.x_proj.bias.copy_(torch.cat([_t(g[k]["bias"], dev) for k in ("ir", "iz", "in")]))
    gru.h_proj.weight.copy_(torch.cat([_t(g[k]["kernel"], dev).T for k in ("hr", "hz")]))
    _load_dense(gru.hn, g["hn"])


def _load_conv(conv, p) -> None:
    """A flax ``Conv`` {kernel (kh, kw, in, out), bias} into an
    ``nn.Conv2d``: HWIO → OIHW (a depthwise kernel (kh, kw, 1, C) → (C, 1,
    kh, kw))."""
    conv.weight.copy_(_t(p["kernel"], conv.weight.device).permute(3, 2, 0, 1))
    conv.bias.copy_(_t(p["bias"], conv.bias.device))


def _load_conv_transpose(layer, p) -> None:
    """A flax ``ConvTranspose`` (``transpose_kernel=False``) {kernel (kh, kw,
    in, out), bias} into an ``nn.ConvTranspose2d``: torch's transposed
    convolution flips the kernel, so it is flipped in both spatial axes and
    laid out (in, out, kh, kw)."""
    k = _t(p["kernel"], layer.weight.device)
    layer.weight.copy_(torch.flip(k, (0, 1)).permute(2, 3, 0, 1))
    layer.bias.copy_(_t(p["bias"], layer.bias.device))


def _load_norm(norm, p) -> None:
    """A flax ``LayerNorm`` or ``GroupNorm`` {scale, bias}."""
    norm.weight.copy_(_t(p["scale"], norm.weight.device))
    norm.bias.copy_(_t(p["bias"], norm.bias.device))


def _load_dense_from_image(layer, p, chw) -> None:
    """A Dense whose input is an NHWC image flattened: kernel rows (H, W, C)
    → the port's (C, H, W)."""
    c, h, w = chw
    kernel = _t(p["kernel"], layer.weight.device)
    layer.weight.copy_(kernel.reshape(h, w, c, -1).permute(3, 2, 0, 1).reshape(-1, c * h * w))
    layer.bias.copy_(_t(p["bias"], layer.bias.device))


def _load_dense_to_image(layer, p, chw) -> None:
    """A Dense whose output is reshaped to an NHWC image: kernel columns and
    bias (H, W, C) → the port's (C, H, W)."""
    c, h, w = chw
    kernel = _t(p["kernel"], layer.weight.device)
    layer.weight.copy_(kernel.reshape(-1, h, w, c).permute(3, 1, 2, 0).reshape(c * h * w, -1))
    layer.bias.copy_(_t(p["bias"], layer.bias.device).reshape(h, w, c).permute(2, 0, 1)
                     .reshape(-1))


def _load_resnet_cnn(net: ResNetCNN, p) -> None:
    """flax ``ResNetCNN`` {Conv_0, ResNetBlock_i {Conv_0, GroupNorm_0, Conv_1,
    GroupNorm_1, Conv_2 (the shortcut)}, Dense_0}."""
    _load_conv(net.stem, p["Conv_0"])
    for i, block in enumerate(net.blocks):
        b = p[f"ResNetBlock_{i}"]
        _load_conv(block.conv1, b["Conv_0"])
        _load_norm(block.norm1, b["GroupNorm_0"])
        _load_conv(block.conv2, b["Conv_1"])
        _load_norm(block.norm2, b["GroupNorm_1"])
        if block.shortcut is not None:
            _load_conv(block.shortcut, b["Conv_2"])
    _load_dense(net.proj, p["Dense_0"])


def _load_backbone(net, p) -> None:
    """flax ``TorchResNet`` ({conv1, layer<s>_<b> {conv1, conv2[, conv3],
    [downsample]}}), ``MobileNetV3`` or ``EfficientNetV2`` (flat names) into
    the port's module of the same arch."""
    if isinstance(net, TorchResNet):
        _load_conv(net.conv1, p["conv1"])
        for name, block in net.named_children():
            if not name.startswith("layer"):
                continue
            for b, blk in enumerate(block):
                q = p[f"{name}_{b}"]
                for conv_name, conv in blk.named_children():
                    if conv is not None:
                        _load_conv(conv, q[conv_name])
    else:
        for name, conv in net.named_children():
            _load_conv(conv, p[name])


def _load_trans_cnn(net: TransCNN, p) -> None:
    """flax ``TransCNN`` {deconv_i, LayerNorm_i}."""
    for i, layer in enumerate(net.deconv):
        _load_conv_transpose(layer, p[f"deconv_{i}"])
    for i, norm in enumerate(net.norm or ()):
        _load_norm(norm, p[f"LayerNorm_{i}"])


def module_params_from_flax(params, module):
    """The parameters of one flax module of ``visfly_tpu/policies`` (its dict
    of numpy arrays, with or without the ``"params"`` level) into the port's
    module of the same class and settings, in place; returns the module.
    Takes ``MLP``, ``ImageCNN``, ``ResNetCNN``, ``TorchResNet``,
    ``MobileNetV3``, ``EfficientNetV2``, ``TransCNN`` and ``DecoderHead``."""
    p = params.get("params", params)
    with torch.no_grad():
        if isinstance(module, MLP):
            _load_mlp(module, p)
        elif isinstance(module, ImageCNN):
            _load_cnn(module, p)
        elif isinstance(module, ResNetCNN):
            _load_resnet_cnn(module, p)
        elif isinstance(module, (TorchResNet, MobileNetV3, EfficientNetV2)):
            _load_backbone(module, p)
        elif isinstance(module, TransCNN):
            _load_trans_cnn(module, p)
        elif isinstance(module, DecoderHead):
            _load_dense_to_image(module.proj, p["proj"], module.in_shape)
            _load_trans_cnn(module.net, p["TransCNN_0"])
        else:
            raise TypeError(f"no flax counterpart for {type(module).__name__}")
    return module


def _load_extractor(extractor, p) -> None:
    for name, sub in extractor.extractors.items():
        if isinstance(sub, nn.Linear):  # a backbone's <key>_proj
            _load_dense(sub, p[name])
        else:
            module_params_from_flax(p[name], sub)


def actor_params_from_flax(params, module):
    """The parameters of a ``visfly_tpu.policies.networks`` ``Actor`` or
    ``RecurrentActor`` (the flax dict of numpy arrays, with or without its
    ``"params"`` level) into the port's module of the same architecture, in
    place; returns the module. Dense kernels transpose, convolution kernels go
    HWIO → OIHW, the image projection's rows go (H, W, C) → (C, H, W), and the
    GRU's six gates stack into ``x_proj`` [ir | iz | in], ``h_proj`` [hr | hz]
    and ``hn``."""
    p = params.get("params", params)
    with torch.no_grad():
        _load_extractor(module.extractor, p["extractor"])
        _load_mlp(module.latent, p["latent"])
        _load_dense(module.head.mu, p["mu"])
        _load_dense(module.head.log_std, p["log_std"])
        if hasattr(module, "gru"):
            _load_gru(module.gru, p["gru"])
    return module


def policy_params_from_flax(params, module):
    """The parameters of any network of ``visfly_tpu.policies.networks``
    into the port's module of the same architecture and class, in place, by
    the rules of :func:`actor_params_from_flax`; returns the module.
    ``QCritic`` and ``StateCritic`` read ``qf<i>`` / ``vf<i>`` and their
    ``_out`` layers, the actor-critic policies ``mlp_pi``, ``mlp_vf``,
    ``mu``, ``value``, the ``log_std`` vector and, recurrent, ``gru``."""
    if isinstance(module, (Actor, RecurrentActor)):
        return actor_params_from_flax(params, module)
    if not isinstance(module, (QCritic, StateCritic, ActorCriticPolicy,
                               RecurrentActorCriticPolicy)):
        raise TypeError(f"no flax counterpart for {type(module).__name__}")
    p = params.get("params", params)
    with torch.no_grad():
        _load_extractor(module.extractor, p["extractor"])
        if isinstance(module, (QCritic, StateCritic)):
            heads = module.heads
            for i in range(heads.n):
                _load_mlp(getattr(heads, f"{heads.prefix}{i}"), p[f"{heads.prefix}{i}"])
                _load_dense(getattr(heads, f"{heads.prefix}{i}_out"),
                            p[f"{heads.prefix}{i}_out"])
        else:
            h = module.heads
            _load_mlp(h.mlp_pi, p["mlp_pi"])
            _load_mlp(h.mlp_vf, p["mlp_vf"])
            _load_dense(h.mu, p["mu"])
            _load_dense(h.value, p["value"])
            h.log_std.copy_(_t(p["log_std"], h.log_std.device))
            if hasattr(module, "gru"):
                _load_gru(module.gru, p["gru"])
    return module


def _load_gaussian_out(out, p, first: int) -> None:
    """The mean and log-std Dense layers, flax's ``Dense_<first>`` and
    ``Dense_<first + 1>``."""
    _load_dense(out.mean, p[f"Dense_{first}"])
    _load_dense(out.log_std, p[f"Dense_{first + 1}"])


def world_model_params_from_flax(params, world: WorldModel) -> WorldModel:
    """``visfly_tpu.policies.world_model.WorldModel.params`` (the three flax
    trees ``sequence``, ``encoder``, ``decoder`` of numpy arrays) into the
    port's ``WorldModel`` of the same sizes and observations, in place;
    returns it."""
    seq = params["sequence"].get("params", params["sequence"])
    enc = params["encoder"].get("params", params["encoder"])
    dec = params["decoder"].get("params", params["decoder"])
    with torch.no_grad():
        _load_dense(world.sequence.inp, seq["Dense_0"])
        _load_gru(world.sequence.gru, seq["GRUCell_0"])
        _load_dense(world.sequence.hid, seq["Dense_1"])
        _load_gaussian_out(world.sequence.out, seq, 2)
        _load_extractor(world.encoder.obs_extractor, enc["obs_extractor"])
        _load_dense(world.encoder.hid, enc["Dense_0"])
        _load_gaussian_out(world.encoder.out, enc, 1)
        _load_mlp(world.decoder.mlp, dec["mlp"])
        _load_dense(world.decoder.out, dec["Dense_0"])
    return world


def autoencoder_params_from_flax(params, model: DepthAutoencoder) -> DepthAutoencoder:
    """``visfly_tpu.policies.autoencoder.DepthAutoencoder`` parameters
    ({encoder {Conv_i, Dense_0}, decoder {Dense_0, ConvTranspose_i}}) into the
    port's module of the same sizes, in place; returns it. The encoder's
    Dense rows and the decoder's Dense columns go (H, W, C) → (C, H, W)."""
    p = params.get("params", params)
    enc, dec = p["encoder"], p["decoder"]
    with torch.no_grad():
        for i, conv in enumerate(model.encoder.conv):
            _load_conv(conv, enc[f"Conv_{i}"])
        _load_dense_from_image(model.encoder.proj, enc["Dense_0"], model.encoder.feat_shape)
        _load_dense_to_image(model.decoder.proj, dec["Dense_0"], model.decoder.in_shape)
        for i, layer in enumerate(model.decoder.deconv):
            _load_conv_transpose(layer, dec[f"ConvTranspose_{i}"])
    return model


def _gen_and_obs(st, trainer, gen):
    dev = trainer.env.device
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    return dev, gen, {k: _t(v, dev) for k, v in st.obs.items()}


def bptt_state_from_jax(st, trainer, gen: Optional[torch.Generator] = None):
    """``visfly_tpu.algos.BPTTState`` of numpy arrays → the port's
    ``BPTTState`` for ``trainer`` (a ``visfly_tpu_torch.algos.BPTT`` over the
    same env and policy settings): the env state, observation and hidden state
    cross over, the actor is built for the observation and given the
    parameters, and the optimiser starts fresh (Adam's moments do not cross).
    ``gen`` takes the place of both PRNG keys."""
    dev, gen, obs = _gen_and_obs(st, trainer, gen)
    trainer.build(obs)
    actor_params_from_flax(st.params, trainer.actor)
    hidden = () if isinstance(st.hidden, tuple) else _t(st.hidden, dev)
    return trainer._state(env_state_from_numpy(st.env_state, gen, dev), obs, gen,
                          int(st.global_step), hidden)


def episode_stats_from_numpy(stats, device=None) -> EpisodeStats:
    """``visfly_tpu.algos.ppo.EpisodeStats`` of numpy arrays → EpisodeStats."""
    return EpisodeStats(_t(stats.returns, device), _t(stats.lengths, device),
                        _t(stats.success, device), _t(stats.pos, device, torch.int64),
                        _t(stats.count, device, torch.int64))


def ppo_state_from_jax(st, trainer, gen: Optional[torch.Generator] = None):
    """``visfly_tpu.algos.PPOState`` of numpy arrays → the port's
    ``PPOState`` for ``trainer`` (a ``visfly_tpu_torch.algos.PPO`` over the
    same env and settings): the env state, observation, episode window and
    hidden state cross over, the policy is built and given the parameters,
    and the optimiser starts fresh (Adam's moments do not cross). ``gen``
    takes the place of both PRNG keys."""
    dev, gen, obs = _gen_and_obs(st, trainer, gen)
    trainer.build(obs)
    policy_params_from_flax(st.params, trainer.policy)
    hidden = () if isinstance(st.hidden, tuple) else _t(st.hidden, dev)
    return trainer._state(env_state_from_numpy(st.env_state, gen, dev), obs, gen,
                          int(st.global_step), episode_stats_from_numpy(st.ep_stats, dev),
                          hidden)


def _critics_from_jax(st, trainer) -> None:
    policy_params_from_flax(st.critic_params, trainer.critic)
    policy_params_from_flax(st.critic_target_params, trainer.critic_target)


def shac_state_from_jax(st, trainer, gen: Optional[torch.Generator] = None):
    """``visfly_tpu.algos.SHACState`` of numpy arrays → the port's
    ``SHACState`` for ``trainer``: env state and observation, the actor's,
    critic's and target critic's parameters; both optimisers start fresh
    (Adam's moments do not cross). ``gen`` takes the place of both PRNG
    keys."""
    dev, gen, obs = _gen_and_obs(st, trainer, gen)
    trainer.build(obs)
    actor_params_from_flax(st.actor_params, trainer.actor)
    _critics_from_jax(st, trainer)
    return trainer._state(env_state_from_numpy(st.env_state, gen, dev), obs, gen,
                          int(st.global_step))


def apg_state_from_jax(st, trainer, gen: Optional[torch.Generator] = None):
    """``visfly_tpu.algos.APGState`` of numpy arrays → the port's
    ``APGState`` for ``trainer``: env state, observation and the actor's
    parameters; the optimiser starts fresh (Adam's moments do not cross).
    ``gen`` stands in for the env state's PRNG key."""
    dev, gen, obs = _gen_and_obs(st, trainer, gen)
    trainer.build(obs)
    actor_params_from_flax(st.params, trainer.actor)
    return trainer._state(env_state_from_numpy(st.env_state, gen, dev), obs,
                          int(st.global_step))


def buffer_from_numpy(buf, device=None) -> ReplayBuffer:
    """``visfly_tpu.algos.buffers.ReplayBuffer`` of numpy arrays →
    ReplayBuffer (its ring position and fill flag as Python values)."""
    full_states = () if isinstance(buf.full_states, tuple) else _t(buf.full_states, device)
    return ReplayBuffer(
        obs={k: _t(v, device) for k, v in buf.obs.items()},
        next_obs={k: _t(v, device) for k, v in buf.next_obs.items()},
        actions=_t(buf.actions, device), rewards=_t(buf.rewards, device),
        dones=_t(buf.dones, device, torch.bool), pos=int(buf.pos), full=bool(buf.full),
        full_states=full_states)


def sac_state_from_jax(st, trainer, gen: Optional[torch.Generator] = None):
    """``visfly_tpu.algos.SACState`` of numpy arrays → the port's
    ``SACState`` for ``trainer``: env state, observation, replay buffer,
    the actor's, critic's and target critic's parameters and ``log_alpha``;
    the three optimisers start fresh (Adam's moments do not cross). ``gen``
    takes the place of both PRNG keys."""
    dev, gen, obs = _gen_and_obs(st, trainer, gen)
    trainer.build(obs)
    actor_params_from_flax(st.actor_params, trainer.actor)
    _critics_from_jax(st, trainer)
    with torch.no_grad():
        trainer.log_alpha.copy_(_t(st.log_alpha, dev))
    return trainer._state(buffer_from_numpy(st.buffer, dev),
                          env_state_from_numpy(st.env_state, gen, dev), obs, gen,
                          int(st.global_step))
