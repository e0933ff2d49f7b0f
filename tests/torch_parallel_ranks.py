"""Rank-side code of the port's multi-device tests.

``spawn`` starts ``nprocs`` CPU processes joined by a gloo process group
(rendezvous through a ``file://`` path under the test's ``tmp_path``, so
concurrent test workers never share a TCP port); each runs one of the
``leg_*`` functions below and writes what it returns to
``rank{r}.pt``.  The ranks import torch and the port only: the JAX
oracles run in the test process."""

import datetime
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _main(rank, nprocs, root, leg, args):
    torch.set_num_threads(1)
    os.environ['LOCAL_WORLD_SIZE'] = str(nprocs)
    dist.init_process_group(
        'gloo', init_method='file://' + os.path.join(root, 'rendezvous'),
        rank=rank, world_size=nprocs,
        timeout=datetime.timedelta(seconds=120))
    try:
        out = globals()[leg](rank, *args)
        torch.save(out, os.path.join(root, f'rank{rank}.pt'))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(leg: str, nprocs: int, root, *args):
    """Run ``leg(rank, *args)`` on ``nprocs`` gloo ranks; returns the ranks'
    results in rank order."""
    root = str(root)
    mp.spawn(_main, args=(nprocs, root, leg, args), nprocs=nprocs, join=True)
    return [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=False)
            for r in range(nprocs)]


# ---------------------------------------------------------------- training

SMALL = dict(n_layer=2, n_head=2, d_model=32, d_ff=64, d_embed=32,
             favor_dims=16)
GPT2_SMALL = dict(n_layer=2, n_head=4, d_model=64, d_ff=128, d_embed=64)


def performer(V, state, heads_last=False):
    from emo_disentanger_tpu_torch.models import MusicPerformer
    tm = MusicPerformer(n_token=V, dropout=0.0, heads_last=heads_last,
                        device='cpu', **SMALL)
    tm.load_state_dict(state)
    return tm


def gpt2(V, state):
    from emo_disentanger_tpu_torch.models import MusicGPT2
    tm = MusicGPT2(n_token=V, dropout=0.0, device='cpu', **GPT2_SMALL)
    tm.load_state_dict(state)
    return tm


def train_steps(model, omegas, batches, cfg, pad, mesh=None):
    """(losses, parameters) after one train step a batch; over a ``mesh``
    each step takes this rank's rows."""
    from emo_disentanger_tpu_torch.parallel import shard_batch
    from emo_disentanger_tpu_torch.train import trainer as ttr
    opt = ttr.make_optimizer(model.parameters(), ttr.OptimizerConfig(**cfg))
    step = ttr.make_train_step(ttr.stage2_performer_loss_fn(model, pad), model,
                               opt, mesh)
    losses = []
    for b in batches:
        loss, _ = step(ttr.batch_to_device(shard_batch(mesh, b), 'cpu'),
                       {'omegas': omegas})
        losses.append(float(loss))
    return losses, {n: p.detach().clone() for n, p in model.named_parameters()}


def txl(state, shape):
    from emo_disentanger_tpu_torch.models import PlainTransformer
    model = PlainTransformer(state['dec_out_proj.bias'].shape[0], dropout=0.0,
                             device='cpu', **shape)
    model.load_state_dict(state)
    return model


def segmented_steps(state, shape, segs, cfg, pad, mesh=None):
    """(losses, final memories of this rank's rows, parameters) of one
    stage-1 segmented step a segment, memories carried; over a mesh with
    tp > 1 the model is sharded first (the parameters are this rank's
    shards)."""
    from emo_disentanger_tpu_torch.parallel import shard_batch, shard_params
    from emo_disentanger_tpu_torch.train import trainer as ttr
    model = txl(state, shape)
    if mesh is not None:
        shard_params(model, mesh)
    opt = ttr.make_optimizer(model.parameters(), ttr.OptimizerConfig(**cfg))
    step = ttr.make_segmented_train_step(model, pad, opt, mesh)
    rows = shard_batch(mesh, segs[0])['dec_inp'].shape[0]
    mems = torch.zeros(model.n_layer + 1, rows, model.mem_len, model.d_model)
    losses = []
    for b in segs:
        mems, loss, _ = step({k: torch.as_tensor(v).long()
                              for k, v in shard_batch(mesh, b).items()}, mems)
        losses.append(float(loss))
    return losses, mems, {n: p.detach().clone()
                          for n, p in model.named_parameters()}


def stage1_steps(model, batches, cfg, pad, mesh=None):
    """(losses, parameters, the first step's gradients after the data
    reduction and before the clip) of one stage-1 train step a batch; over
    a ``mesh`` each step takes this rank's rows."""
    from emo_disentanger_tpu_torch.parallel import shard_batch
    from emo_disentanger_tpu_torch.train import trainer as ttr
    opt = ttr.make_optimizer(model.parameters(), ttr.OptimizerConfig(**cfg))
    step = ttr.make_train_step(ttr.stage1_loss_fn(model, pad), model, opt, mesh)
    grads, adam = {}, opt.step

    def keep_first_grads():
        if not grads:
            grads.update({n: p.grad.detach().clone()
                          for n, p in model.named_parameters()})
        return adam()
    opt.step = keep_first_grads
    losses = [float(step(ttr.batch_to_device(shard_batch(mesh, b), 'cpu'),
                         {})[0]) for b in batches]
    return losses, {n: p.detach().clone()
                    for n, p in model.named_parameters()}, grads


def leg_txl_tp(rank, state, shape, mem_state, tokens, batches, cfg, pad,
               segmented):
    """On a world of four, dp=2 x tp=2: the Transformer-XL forward over two
    segments (the second on the first's memories), the refusal to decode,
    three Adam steps and two segmented steps."""
    from emo_disentanger_tpu_torch.parallel import make_mesh, shard_params
    mesh = make_mesh(tp=2, backend='gloo', device_type='cpu')
    out = {}
    model = shard_params(txl(mem_state, dict(shape, mem_len=8)), mesh)
    with torch.no_grad():
        first, mems = model(tokens[0])
        second, mems = model(tokens[1], mems)
    out['forward'] = (first, second, torch.stack(mems))
    out['heads'] = model.decoder.layers[0].dec_attn.qkv_net.weight.shape[0]
    try:
        model.init_decode_cache(2, 16)
        out['decode'] = None
    except NotImplementedError as e:
        out['decode'] = str(e)
    out['train'] = stage1_steps(shard_params(txl(state, shape), mesh), batches,
                                cfg, pad, mesh)
    out['segmented'] = segmented_steps(*segmented, mesh=mesh)
    return out


def leg_train(rank, meshes, V, state, omegas, batches, cfg, pad):
    """Three Adam steps of the Performer under each mesh shape of
    ``meshes`` ((tp, dcn) pairs over the whole world)."""
    from emo_disentanger_tpu_torch.parallel import make_mesh, shard_params
    out = {}
    for tp, dcn in meshes:
        mesh = make_mesh(tp=tp, dcn=dcn, backend='gloo', device_type='cpu')
        model = shard_params(performer(V, state), mesh)
        out[(tp, dcn)] = train_steps(model, omegas, batches, cfg, pad, mesh)
    return out


def leg_two_ranks(rank, V, state, omegas, gpt2_state, tokens, segs,
                  batches, cfg, pad, s2_config, s1_config, segmented):
    """On a world of two: the Performer and GPT-2 forwards at tp=2, three
    dp=2 Adam steps, two dp=2 stage-1 segmented steps, one stage-2 and
    one stage-1 ``run`` at ``n_devices=2``, and the refusals that need a
    process group."""
    from emo_disentanger_tpu_torch.parallel import make_mesh, shard_params
    from emo_disentanger_tpu_torch.parallel.mesh import check_replicas
    from emo_disentanger_tpu_torch.train import train_stage1, train_stage2
    out = {}
    tp = make_mesh(2, tp=2, backend='gloo', device_type='cpu')
    with torch.no_grad():
        for key, hl in (('performer_tp', False), ('performer_tp_hl', True)):
            out[key] = shard_params(performer(V, state, hl), tp)(
                tokens, omegas, segs)
        out['gpt2_tp'] = shard_params(gpt2(V, gpt2_state), tp)(tokens, segs)
    dp = make_mesh(2, backend='gloo', device_type='cpu')
    out['dp'] = train_steps(performer(V, state), omegas, batches, cfg, pad, dp)
    out['segmented'] = segmented_steps(*segmented, mesh=dp)

    # a replica that differs is caught
    drifted = performer(V, state)
    if rank == 1:
        with torch.no_grad():
            drifted.dec_out_proj.bias[0] += 1.0
    try:
        check_replicas(drifted, dp)
        out['drift'] = None
    except RuntimeError as e:
        out['drift'] = str(e)
    out['refusals'] = {}
    for name, call in (
            ('n_devices', lambda: make_mesh(4, backend='gloo',
                                            device_type='cpu')),
            ('backend', lambda: make_mesh(backend='nccl', device_type='cpu')),
            ('divisible', lambda: make_mesh(tp=4, backend='gloo',
                                            device_type='cpu'))):
        try:
            call()
            out['refusals'][name] = None
        except ValueError as e:
            out['refusals'][name] = str(e)

    real = train_stage2.build_model_and_params

    def no_dropout(*a, **kw):
        model, om = real(*a, **kw)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        return model, om
    train_stage2.build_model_and_params = no_dropout
    out['run2'] = train_stage2.run(s2_config, 'functional', n_devices=2,
                                   device='cpu')
    out['run1'] = train_stage1.run(s1_config, 'functional', n_devices=2,
                                   device='cpu')
    return out


# ----------------------------------------------------------------- serving

def leg_serve(rank, cases):
    """Each case: (kind, model state, generator kwargs, method, job
    arguments); the generator runs over a dp=2 mesh."""
    from emo_disentanger_tpu_torch.infer import (
        Stage1BatchGenerator, Stage2BatchGenerator)
    from emo_disentanger_tpu_torch.models import PlainTransformer
    from emo_disentanger_tpu_torch.parallel import make_mesh
    mesh = make_mesh(2, backend='gloo', device_type='cpu')
    out = []
    for kind, shape, state, vocab, kw, method, args in cases:
        n_token = state['dec_out_proj.bias'].shape[0]
        if kind == 'stage1':
            model = PlainTransformer(n_token, device='cpu', **shape)
            model.load_state_dict(state)
            gen = Stage1BatchGenerator(model.eval(), vocab, mesh=mesh,
                                       device='cpu', **kw)
        else:
            build = performer if kind == 'performer' else gpt2
            model = build(n_token, state).eval()
            gen = Stage2BatchGenerator(model, vocab, mesh=mesh, device='cpu',
                                       **kw)
        streams, stats = getattr(gen, method)(*args[0], **args[1])
        # times are each rank's own host clock
        out.append((streams, {k: v for k, v in stats.items() if
                              'seconds' not in k and not k.endswith('_s')}))
    return out


def unshard(pieces, dim, blocks=1):
    """The inverse of ``sharding_rules._shard``: the full tensor from the
    tp ranks' pieces, in tp order."""
    parts = [p.chunk(blocks, dim) for p in pieces]
    return torch.cat([torch.cat([p[k] for p in parts], dim)
                      for k in range(blocks)], dim)
