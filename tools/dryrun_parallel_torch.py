"""Dry run of the port's parallel paths on N ranks of one host: the
counterpart of ``__graft_entry__.dryrun_multichip``'s paths 1 to 11, at
its tiny sizes.

1. one GraspPointCNN training step with the batch sharded over ``data``
   and the dense layers over ``model`` (a (N/2, 2) mesh for an even N);
2. the data-parallel batched frame pipeline over 2 frames a data rank;
2b. the row-sharded single-frame pipeline (32 rows a data rank);
3. a TinyVLA LoRA fine-tune with its projections tensor-parallel over
   ``model`` (``tensor_parallel_``);
4. the tensor-parallel LLaVA forward;
5. - 7. tensor-parallel padded-batch greedy generate in f32, int8 and
   int4 (group 8);
8. the GPipe LLaVA forward, one stage a data rank, as many microbatches;
9. pipeline over ``data`` times tensor parallelism over ``model``;
10. one pipeline-parallel LoRA step with remat: ``lora_b`` must move and
    ``lora_a``'s first-step gradient is exactly 0 (``lora_b`` starts at 0);
11. tensor-parallel anyres generate (more packed tokens than one tile's).

    python tools/dryrun_parallel_torch.py --ranks 4 --device cpu
    python tools/dryrun_parallel_torch.py --ranks 2 --device cuda

It spawns its ranks itself (one process each, a file store under
``build/``). ``--device cuda`` puts rank r on card r mod the card count;
several ranks on one card need ``--backend gloo`` (the default; nccl
refuses two ranks on one GPU). Rank 0 prints a line a path and, last,
one JSON object with ``"ok": true``; any rank's failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _rank(rank, world, device):
    import torch
    from leafgrasp_tpu_torch.config import (FrameConfig,
                                            LeafSelectionConfig,
                                            ModelConfig, PipelineConfig,
                                            TrainConfig)
    from leafgrasp_tpu_torch.io.scenes import make_leaf_scene
    from leafgrasp_tpu_torch.models.grasp_cnn import (GraspPointCNN,
                                                      init_like_flax_)
    from leafgrasp_tpu_torch.parallel import (make_batched_frame_fn,
                                              make_mesh,
                                              make_sharded_frame_fn)
    from leafgrasp_tpu_torch.parallel.mesh import mesh_device, mesh_shape
    from leafgrasp_tpu_torch.training.train import (make_optimizer,
                                                    make_parallel_train_step,
                                                    parallelize_grasp_cnn)

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    lines = []
    model_axis = 2 if world % 2 == 0 else 1
    mesh = make_mesh(world, model_axis=model_axis, device=device)
    shape = mesh_shape(mesh)
    dev = mesh_device(mesh)

    # ---- 1) CNN train step: dp over data, tp over model ----------------
    torch.manual_seed(0)
    model_cfg = ModelConfig(encoder_filters=(8, 16), attention_type="hybrid")
    train_cfg = TrainConfig(batch_size=2 * shape["data"])
    model = init_like_flax_(GraspPointCNN(model_cfg),
                            torch.Generator().manual_seed(0)).to(dev)
    bs = train_cfg.batch_size
    model, sharded, rows = parallelize_grasp_cnn(model, mesh, bs)
    step = make_parallel_train_step(model, make_optimizer(model, train_cfg),
                                    train_cfg, mesh, sharded)
    feats = torch.ones((bs, 32, 32, 9), device=dev)[rows]
    labels = torch.ones(bs, device=dev)[rows]
    loss, _ = step(feats, labels, torch.ones_like(labels),
                   float(train_cfg.pos_weight))
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    lines.append(f"dryrun_parallel_torch({world}): mesh={shape} CNN dp+tp "
                 f"train step loss={loss:.4f} ({len(sharded)} sharded "
                 f"tensors) OK")

    # ---- 2) data-parallel batched inference pipeline -------------------
    pcfg = PipelineConfig(frame=FrameConfig(height=96, width=128,
                                            max_leaves=4),
                          leaf=LeafSelectionConfig(min_leaf_area=200))
    b = 2 * shape["data"]
    mask, depth = make_leaf_scene(96, 128, 3, seed=1, margin=16)
    masks = np.stack([np.roll(mask, i, 1) for i in range(b)])
    depths = np.stack([np.roll(depth, i, 1) for i in range(b)])
    res = make_batched_frame_fn(mesh, pcfg)(
        masks, depths, np.float32(64.0), np.float32(48.0), np.float32(200.0))
    if tuple(res.grasp_uv.shape) != (b, 2):
        raise RuntimeError(f"batched grasp_uv {tuple(res.grasp_uv.shape)}")
    lines.append(f"dryrun_parallel_torch({world}): dp batched pipeline "
                 f"over {b} frames OK")

    # ---- 2b) row-sharded single-frame pipeline --------------------------
    sp_h = 32 * shape["data"]
    scfg = PipelineConfig(frame=FrameConfig(height=sp_h, width=128,
                                            max_leaves=4),
                          leaf=LeafSelectionConfig(min_leaf_area=200))
    smask, sdepth = make_leaf_scene(sp_h, 128, 3, seed=1, margin=16)
    sfn = make_sharded_frame_fn(mesh, scfg)
    sres = sfn(smask, sdepth, np.float32(64.0), np.float32(sp_h / 2.0),
               np.float32(200.0))
    if tuple(sres.grasp_uv.shape) != (2,):
        raise RuntimeError(f"sharded grasp_uv {tuple(sres.grasp_uv.shape)}")
    lines.append(f"dryrun_parallel_torch({world}): row-sharded full-frame "
                 f"pipeline ({shape['data']}-way spatial, "
                 f"{sfn.axis.calls} collectives, {sfn.axis.bytes} bytes) OK")
    lines += _vla_paths(world, mesh, shape, dev)
    return {"lines": lines, "mesh": shape, "loss": loss,
            "uv": sres.grasp_uv.tolist()}


def _tiny_llava(dev, seed, **kw):
    """``dryrun_multichip``'s tiny LLaVA (widths a multiple of the model
    axis) with seeded weights, and its config."""
    import torch
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     LlavaTorchConfig,
                                                     init_random_)
    fields = dict(vis_hidden=16, vis_intermediate=32, vis_layers=1,
                  vis_heads=2, image_size=28, patch_size=14, vocab_size=64,
                  layers=1, heads=2, kv_heads=1, image_token_index=60)
    cfg = LlavaTorchConfig(**{**fields, **kw})
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_random_(LlavaTorch(cfg, device=dev), gen)


def _vla_paths(world, mesh, shape, dev):
    """Paths 3 to 11: the VLA models, tensor- and pipeline-parallel."""
    import dataclasses
    import torch
    from leafgrasp_tpu_torch.parallel import (make_pp_llava_forward,
                                              shard_stage_params,
                                              split_decoder_stages,
                                              tensor_parallel_)
    from leafgrasp_tpu_torch.vla.convert import (llava_flax_name,
                                                 torch_to_flax_tiny_vla)
    from leafgrasp_tpu_torch.vla.lm import VLAModelConfig
    from leafgrasp_tpu_torch.vla.llava_next import (pack_anyres_features,
                                                    preprocess_anyres)
    from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                     attach_lora,
                                                     greedy_generate_llava)
    from leafgrasp_tpu_torch.vla.quant import quantize_llava_variables
    from leafgrasp_tpu_torch.vla.trainer import (VLATrainer,
                                                 make_synthetic_vla_dataset)

    lines = []
    tp = shape["model"]
    tag = f"dryrun_parallel_torch({world}):"

    # ---- 3) TinyVLA LoRA fine-tune, tensor-parallel ---------------------
    vcfg = VLAModelConfig(dim=8 * tp, n_layers=1, n_heads=2, n_kv_heads=1,
                          mlp_hidden=16 * tp, vision_tokens=2,
                          vision_patch=16, lora_rank=2, max_seq=600)
    trainer = VLATrainer(cfg=vcfg, learning_rate=1e-3, device=dev)
    state = trainer.model.state_dict()
    tensor_parallel_(trainer.model, mesh, lambda k: next(iter(
        torch_to_flax_tiny_vla({k: state[k]}))))
    fit = trainer.fine_tune(make_synthetic_vla_dataset(
        2, seed=0, num_candidates=2, image_size=16), epochs=1, batch_size=2)
    _finite("tp VLA LoRA loss", torch.tensor(fit["final_loss"]))
    lines.append(f"{tag} tp VLA LoRA step loss={fit['final_loss']:.4f} OK")

    # ---- 4) tensor-parallel LLaVA forward -------------------------------
    hw = dict(hidden=8 * tp, intermediate=16 * tp)
    lcfg, lmodel = _tiny_llava(dev, 0, **hw)
    base = lmodel.state_dict()
    tensor_parallel_(lmodel, mesh, llava_flax_name)
    ids = torch.tensor([[1, 60, 60, 60, 60, 2]], device=dev)
    with torch.no_grad():
        logits, _ = lmodel(ids, torch.zeros((1, 28, 28, 3), device=dev))
    _finite("tp LLaVA logits", logits)
    lines.append(f"{tag} tp LLaVA forward OK")

    # ---- 5-7) tensor-parallel generate: f32, int8, int4 -----------------
    idsb = torch.tensor([[1, 60, 60, 60, 60, 2, 3],
                         [0, 1, 60, 60, 60, 60, 5]], device=dev)
    pxb = torch.zeros((2, 28, 28, 3), device=dev)
    pads = torch.tensor([0, 1], device=dev)
    for name, kw in (("", {}), (" int8-quantized", dict(bits=8)),
                     (" int4 group-quantized", dict(bits=4, group=8))):
        model = lmodel
        if kw:
            qcfg = dataclasses.replace(lcfg, quantized=True,
                                       quant_bits=kw["bits"],
                                       quant_group=kw.get("group", 128))
            model = LlavaTorch.from_state(
                qcfg, quantize_llava_variables(base, **kw))
            tensor_parallel_(model, mesh, llava_flax_name)
        toks = greedy_generate_llava(model, idsb, pxb, max_new_tokens=3,
                                     pad_lens=pads)
        if tuple(toks.shape) != (2, 3):
            raise RuntimeError(f"tp generate tokens {tuple(toks.shape)}")
        lines.append(f"{tag} tp{name} LLaVA "
                     f"{'padded-batch ' if not kw else ''}generate OK")

    # ---- 8) pipeline-parallel LLaVA forward -----------------------------
    n_stages = shape["data"]
    pids = idsb[:1].repeat(n_stages, 1)
    ppx = torch.zeros((n_stages, 28, 28, 3), device=dev)
    pcfg, pmodel = _tiny_llava(dev, 2, layers=n_stages, **hw)
    stages, rest = split_decoder_stages(pmodel.state_dict(), pcfg,
                                        n_stages)
    fn = make_pp_llava_forward(mesh, pmodel, n_microbatches=n_stages)
    with torch.no_grad():
        plogits = fn(rest, shard_stage_params(mesh, stages), pids, ppx)
    _finite("pp LLaVA logits", plogits)
    lines.append(f"{tag} pp LLaVA forward ({n_stages} stages, {n_stages} "
                 f"microbatches) OK")

    # ---- 9) pipeline x tensor parallel ----------------------------------
    tcfg, tmodel = _tiny_llava(dev, 3, layers=n_stages, heads=2 * tp,
                               kv_heads=tp, **hw)
    stages, rest = split_decoder_stages(tmodel.state_dict(), tcfg,
                                        n_stages)
    fn = make_pp_llava_forward(mesh, tmodel, n_microbatches=n_stages,
                               tp_axis="model")
    with torch.no_grad():
        tlogits = fn(rest, shard_stage_params(mesh, stages,
                                              tp_axis="model"), pids, ppx)
    _finite("pp x tp LLaVA logits", tlogits)
    lines.append(f"{tag} pp x tp LLaVA forward ({n_stages} stages x {tp}-way"
                 f" TP) OK")

    # ---- 10) pipeline-parallel LoRA step with remat ---------------------
    rcfg, rmodel = _tiny_llava(dev, 4, layers=n_stages, lora_rank=2, **hw)
    attach_lora(rmodel, {k: v for k, v in rmodel.state_dict().items()
                         if not k.endswith(("lora_a", "lora_b"))},
                torch.Generator(device=dev).manual_seed(5))
    stages, rest = split_decoder_stages(rmodel.state_dict(), rcfg,
                                        n_stages)
    local = shard_stage_params(mesh, stages)
    adapters = {n: p for n, p in local.named_parameters()
                if n.endswith(("lora_a", "lora_b"))}
    for p in list(rest.parameters()) + list(local.parameters()):
        p.requires_grad_(False)
    for p in adapters.values():
        p.requires_grad_(True)
    fn = make_pp_llava_forward(mesh, rmodel, n_microbatches=n_stages,
                               remat=True)
    logp = torch.log_softmax(fn(rest, local, pids, ppx), dim=-1)
    tgt = pids % rcfg.vocab_size
    lloss = -torch.gather(logp, -1, tgt[..., None]).mean()
    grads = torch.autograd.grad(lloss, list(adapters.values()))
    moved = False
    with torch.no_grad():
        for (name, p), g in zip(adapters.items(), grads):
            if name.endswith("lora_a") and bool(g.abs().max() > 0):
                raise RuntimeError(f"{name}: a first-step lora_a gradient "
                                   f"is not 0")
            p -= 1e-2 * g
            moved |= name.endswith("lora_b") and bool(g.abs().max() > 0)
    if not moved:
        raise RuntimeError("pp LoRA step produced zero adapter movement")
    lloss = float(lloss.detach())
    _finite("pp LoRA loss", torch.tensor(lloss))
    lines.append(f"{tag} pp LoRA training step ({n_stages} stages, remat) "
                 f"loss={lloss:.4f} OK")

    # ---- 11) tensor-parallel anyres (LLaVA-NeXT) generate ---------------
    pins = ((28, 56), (56, 28), (56, 56))
    acfg = dataclasses.replace(lcfg, image_grid_pinpoints=pins)
    astate = dict(base, image_newline=torch.full((lcfg.hidden,), 0.01,
                                                 device=dev))
    amodel = LlavaTorch.from_state(acfg, astate)
    tensor_parallel_(amodel, mesh, llava_flax_name)
    img = (np.random.default_rng(6).random((40, 50, 3)) * 255).astype(
        np.uint8)
    tiles, ahw = preprocess_anyres(img, pins, acfg)
    with torch.no_grad():
        feats = amodel.vision_project(torch.as_tensor(tiles, device=dev))
    packed = pack_anyres_features(feats.cpu().numpy(), ahw, pins, acfg,
                                  astate["image_newline"].cpu().numpy())
    n_img = packed.shape[0]
    aids = torch.tensor([[1] + [60] * n_img + [2, 3]], device=dev)
    atoks = greedy_generate_llava(
        amodel, aids, image_features=torch.as_tensor(packed,
                                                     device=dev)[None],
        max_new_tokens=3)
    if tuple(atoks.shape) != (1, 3) or n_img <= acfg.num_patches:
        raise RuntimeError(f"anyres: {tuple(atoks.shape)} tokens from "
                           f"{n_img} packed rows")
    lines.append(f"{tag} tp anyres LLaVA-NeXT generate ({len(tiles)} tiles "
                 f"-> {n_img} packed tokens) OK")
    return lines


def _finite(what, t) -> None:
    import torch
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError(f"{what}: not finite")


def main(argv=None) -> int:
    from leafgrasp_tpu_torch.parallel.launch import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds for the whole run")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device: pass --device cpu", file=sys.stderr)
            return 2
    store = os.path.join("build", f"dryrun_store_{os.getpid()}")
    os.makedirs("build", exist_ok=True)
    outs = run_ranks(_rank, args.ranks, store, args.device,
                     backend=args.backend, timeout_s=60.0,
                     join_s=args.timeout,
                     threads=1 if args.device == "cpu" else 0)
    if any(o["uv"] != outs[0]["uv"] or o["loss"] != outs[0]["loss"]
           for o in outs):
        raise RuntimeError("the ranks disagree")
    for line in outs[0]["lines"]:
        print(line)
    print(json.dumps({"ok": True, "ranks": args.ranks,
                      "device": args.device, "mesh": outs[0]["mesh"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
