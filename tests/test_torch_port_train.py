"""The port's training step against the JAX package on the CPU.

render_rays in its training form (JAX's own perturbation draws fed in),
the gradients of compute_losses for every parameter, the losses, the
optimizer (with a non-finite step), SimpleTrainer and checkpoints written
by either package's trainer. Same params on both sides: a JAX Field.init
carried over with bridge, the table scaled to N(0, 0.5) so density is
non-trivial. Small sizes: 2 levels x 8 features x 2^10 rows (and the F = 2
lanes layout), hidden 32, 64 rays, num_steps 8, proposal_steps 16. The
JAX side runs grid_impl='xla' (its hybrid Pallas encode has no interpret
switch) and heads_impl='pallas' in interpret mode, which reaches
`_bwd_kernel` and `_mlp3_bwd_kernel` through jax.grad. Both compute in
fp32: rtol=1e-4 covers the summation order, with atol=1e-6 relative to
each gradient's largest magnitude.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autolabel_tpu.inference import InferenceModel as JaxInferenceModel
from autolabel_tpu.models.field import Field as JaxField
from autolabel_tpu.models.field import FieldConfig as JaxFieldConfig
from autolabel_tpu.ops.encoders import HashGridConfig as JaxGridConfig
from autolabel_tpu.render.renderer import RenderOptions as JaxRenderOptions
from autolabel_tpu.render.renderer import render_rays as jax_render_rays
from autolabel_tpu.train import checkpoints as jax_checkpoints
from autolabel_tpu.train import optim as jax_optim
from autolabel_tpu.train.losses import LossOptions as JaxLossOptions
from autolabel_tpu.train.losses import compute_losses as jax_compute_losses
from autolabel_tpu.train.metrics import MetricsLogger as JaxMetricsLogger
from autolabel_tpu.train.trainer import SimpleTrainer as JaxSimpleTrainer
from autolabel_tpu_torch import bridge
from autolabel_tpu_torch.inference import InferenceModel
from autolabel_tpu_torch.models.field import Field, FieldConfig
from autolabel_tpu_torch.ops import _kernels
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.render.renderer import (RenderOptions,
                                                 draw_perturbations,
                                                 render_rays)
from autolabel_tpu_torch.train import optim
from autolabel_tpu_torch.train.losses import LossOptions, compute_losses
from autolabel_tpu_torch.train.metrics import MetricsLogger
from autolabel_tpu_torch.train.trainer import SimpleTrainer
from tests.test_torch_port_render import _rays

RTOL, ATOL = 1e-4, 1e-6
N_RAYS, CLASSES = 64, 4
STEPS = dict(num_steps=8, proposal_steps=16)


def _grid(n_features=8):
    return dict(n_levels=2, n_features=n_features, log2_hashmap_size=10,
                base_resolution=8, per_level_scale=1.6)


def _config_kwargs(**overrides):
    kw = dict(encoding='hg+freq', hidden_dim=32, hidden_dim_color=32,
              hidden_dim_semantic=32, semantic_classes=CLASSES, bound=1.0,
              proposal=True, heads_impl='pallas')
    kw.update(overrides)
    return kw


def _jax_field(n_features=8, **overrides):
    return JaxField(JaxFieldConfig(grid=JaxGridConfig(**_grid(n_features)),
                                   **_config_kwargs(**overrides)))


def _port_config(n_features=8, **overrides):
    kw = _config_kwargs(**overrides)
    kw.setdefault('grid_impl', 'pallas')
    return FieldConfig(grid=HashGridConfig(**_grid(n_features)), **kw)


def _port_field(params, n_features=8, **overrides):
    field = Field(_port_config(n_features, **overrides), device='cpu')
    return bridge.load_params(field, params)


def _params(seed=0, n_features=8, **overrides):
    params = jax.tree.map(np.asarray, _jax_field(n_features, **overrides)
                          .init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    grid = params['encoder']['grid']
    params['encoder']['grid'] = rng.normal(0.0, 0.5,
                                           grid.shape).astype(np.float32)
    return params


def _batch(seed=1, features=0):
    o, d, norms = _rays(N_RAYS, seed=seed)
    rng = np.random.default_rng(seed + 100)
    depth = rng.uniform(0.2, 1.5, N_RAYS).astype(np.float32)
    depth[::5] = 0.0  # no depth on these rays
    semantic = rng.integers(0, CLASSES, N_RAYS).astype(np.int32)
    semantic[::3] = -1  # unlabeled rays
    batch = {'rays_o': o, 'rays_d': d, 'direction_norms': norms[:, 0],
             'pixels': rng.uniform(0, 1, (N_RAYS, 3)).astype(np.float32),
             'depth': depth, 'semantic': semantic}
    if features:
        batch['features'] = rng.normal(size=(N_RAYS, features)).astype(
            np.float32)
    return batch


def _torch_batch(batch):
    out = {k: torch.tensor(v) for k, v in batch.items()}
    out['direction_norms'] = out['direction_norms'][:, None]
    return out


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=rtol, atol=atol)


def _close_trees(ours, ref, rtol=RTOL, atol=ATOL, leaf_atol=None):
    """Leaf by leaf, atol relative to each leaf's largest magnitude;
    leaf_atol: a top-level key -> the relative atol of its leaves, where
    it differs."""
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    leaf_atol = leaf_atol or {}
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(ours)[0],
                            jax.tree.leaves(ref)):
        b = np.asarray(b)
        rel = leaf_atol.get(path[0].key, atol)
        _close(a, b, rtol, rel * max(float(np.abs(b).max()), 1e-3))


def _proposal_atol(steps):
    """The proposal net's weight gradients sum one term per proposal sample
    (N_RAYS x proposal_steps), and XLA's CPU sum takes them in an order
    that can change from run to run (seen once in four whole runs of the
    suite: proposal[0], 7.7e-9 off against 1e-9 allowed). Two fp32 sums of
    k terms lie within 2 k 2^-24 of the terms' magnitude, taken as the
    leaf's largest (floor 1e-3), as ATOL takes it."""
    return {'proposal': 2 * N_RAYS * steps['proposal_steps'] * 2.0 ** -24}


def _jax_draws(key, opts):
    """The uniforms JAX's render_rays draws from `key` (renderer.py:212,
    228, 156)."""
    _, k_coarse, k_fine, _ = jax.random.split(key, 4)
    first = opts.proposal_steps or opts.num_steps
    fine = opts.num_steps if opts.proposal_steps else opts.upsample_steps
    draws = {'u_coarse': np.asarray(jax.random.uniform(
        k_coarse, (N_RAYS, first)))}
    if fine:
        draws['u_fine'] = np.asarray(jax.random.uniform(k_fine,
                                                        (N_RAYS, fine)))
    return draws


@pytest.mark.parametrize('branch,n_features', [
    ('proposal_fused', 8), ('proposal_fused', 2), ('uniform_unfused', 8),
    ('upsample', 8)])
def test_perturbed_render_and_loss_gradients_match_jax(branch, n_features):
    overrides, steps = {}, dict(STEPS)
    if branch == 'uniform_unfused':
        overrides, steps = dict(heads_impl='xla', proposal=False), dict(
            num_steps=16)
    elif branch == 'upsample':
        overrides, steps = dict(heads_impl='xla', proposal=False), dict(
            num_steps=8, upsample_steps=8)
    params = _params(n_features=n_features, **overrides)
    batch = _batch()
    jf = _jax_field(n_features, **overrides)
    jopts = JaxRenderOptions(perturb=True, stochastic_corners=0, **steps)
    key = jax.random.PRNGKey(11)

    def jax_loss(p):
        out = jax_render_rays(jf, p, batch['rays_o'], batch['rays_d'],
                              batch['direction_norms'][:, None], key=key,
                              options=jopts)
        loss, parts = jax_compute_losses(out, batch, JaxLossOptions())
        return loss, (parts, out)

    (ref_loss, (ref_parts, ref_out)), ref_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)

    pf = _port_field(params, n_features, **overrides)
    tb = _torch_batch(batch)
    draws = {k: torch.tensor(v) for k, v in _jax_draws(key, jopts).items()}
    out = render_rays(pf, tb['rays_o'], tb['rays_d'], tb['direction_norms'],
                      options=RenderOptions(perturb=True,
                                            stochastic_corners=0, **steps),
                      draws=draws)
    assert set(out) == set(ref_out)
    for k in ref_out:
        _close(out[k], ref_out[k], atol=1e-5)
    if branch.startswith('proposal'):
        assert float(ref_out['interlevel']) > 0
    loss, parts = compute_losses(out, tb, LossOptions())
    _close(loss, ref_loss)
    for k in ref_parts:
        _close(parts[k], ref_parts[k])
    names = [n for n, _ in pf.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in pf.named_parameters()])
    ours = bridge.state_to_numpy(dict(zip(names, grads)))
    _close_trees(ours, ref_grads, leaf_atol=_proposal_atol(steps)
                 if steps.get('proposal_steps') else None)
    assert float(np.abs(ours['encoder']['grid']).max()) > 0


def test_render_draws_come_from_the_generator():
    params = _params()
    pf = _port_field(params)
    tb = _torch_batch(_batch())
    opts = RenderOptions(perturb=True, stochastic_corners=0, **STEPS)
    draws = draw_perturbations(torch.Generator().manual_seed(3), N_RAYS, opts)
    assert draws['u_coarse'].shape == (N_RAYS, 16)
    assert draws['u_fine'].shape == (N_RAYS, 8)
    args = (pf, tb['rays_o'], tb['rays_d'], tb['direction_norms'])
    with torch.no_grad():
        a = render_rays(*args, key=torch.Generator().manual_seed(3),
                        options=opts)
        b = render_rays(*args, options=opts, draws=draws)
        c = render_rays(*args, key=torch.Generator().manual_seed(3),
                        options=dataclasses.replace(opts, perturb=False))
        d = render_rays(*args, options=dataclasses.replace(opts,
                                                           perturb=False))
    torch.testing.assert_close(a['image'], b['image'])
    torch.testing.assert_close(c['image'], d['image'])  # eval: no draws
    assert not torch.equal(a['image'], c['image'])
    # the default options (stochastic_corners 2) render through the
    # stochastic encode, whose uniforms the draws then must carry
    stochastic = RenderOptions(perturb=True, **STEPS)
    with torch.no_grad():
        e = render_rays(*args, key=torch.Generator().manual_seed(3),
                        options=stochastic)
    assert bool(torch.isfinite(e['image']).all())
    assert not torch.equal(a['image'], e['image'])
    with pytest.raises(ValueError):
        render_rays(*args, options=stochastic, draws=draws)


@pytest.mark.parametrize('feature_loss', [False, True])
def test_losses_match_jax(feature_loss):
    rng = np.random.default_rng(12)
    batch = _batch(features=24 if feature_loss else 0)
    outputs = {'image': rng.uniform(0, 1, (N_RAYS, 3)),
               'depth': rng.uniform(0, 2, N_RAYS),
               'semantic': rng.normal(size=(N_RAYS, CLASSES)) * 3,
               'semantic_features': rng.normal(size=(N_RAYS, 32)),
               'interlevel': np.asarray(0.25)}
    outputs = {k: np.asarray(v, np.float32) for k, v in outputs.items()}
    opts = dict(feature_loss=feature_loss, depth_weight=0.3)
    ref_total, ref = jax_compute_losses(outputs, batch,
                                        JaxLossOptions(**opts))
    total, ours = compute_losses({k: torch.tensor(v)
                                  for k, v in outputs.items()},
                                 _torch_batch(batch), LossOptions(**opts))
    assert set(ours) == set(ref)
    _close(total, ref_total)
    for k in ref:
        _close(ours[k], ref[k])
    assert dataclasses.asdict(LossOptions()) == dataclasses.asdict(
        JaxLossOptions())


def _grad_trees(params, n, nonfinite_at):
    rng = np.random.default_rng(13)
    trees = []
    for i in range(n):
        g = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 1e-2).astype(
            np.float32), params)
        if i == nonfinite_at:
            g['encoder']['grid'][0, 3, 1] = np.nan
        trees.append(g)
    return trees


def _flat(tree):
    """JAX tree -> the Field's state-dict names (bridge layout)."""
    return bridge.params_from_numpy(tree, 'cpu')


def test_optimizer_matches_optax_with_a_nonfinite_step():
    params = _params()
    pf = _port_field(params)
    labels = pf.param_labels()
    jax_labels = _flat(jax.tree.map(lambda l: np.asarray(l == 'net'),
                                    JaxField.param_labels(params)))
    assert {k: v == 'net' for k, v in labels.items()} == \
        {k: bool(v) for k, v in jax_labels.items()}
    tx = jax_optim.make_optimizer(params, lr=5e-3, iters=20000)
    state = tx.init(params)
    jparams = params
    opt = optim.Optimizer(pf.named_parameters(), labels, lr=5e-3,
                          iters=20000)
    for g in _grad_trees(params, 5, nonfinite_at=2):
        updates, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = opt.step({k: v for k, v in _flat(g).items()})
        assert bool(applied) == bool(state.last_finite)
    adam = state.inner_state[1]
    assert int(opt.state['count']) == int(adam.count) == 4
    assert int(opt.state['count']) == int(state.inner_state[2].count)
    assert int(opt.state['notfinite_count']) == int(state.notfinite_count)
    assert int(opt.state['total_notfinite']) == int(state.total_notfinite)
    _close_trees(bridge.params_to_numpy(pf), jparams, rtol=1e-5)
    for ours, ref in ((opt.state['mu'], adam.mu), (opt.state['nu'], adam.nu)):
        _close_trees(bridge.state_to_numpy(ours), ref, rtol=1e-5)
    schedule = jax_optim.lr_schedule(5e-3, 20000)
    _close(opt.lr(), schedule(adam.count), rtol=1e-6)
    # the 'pose' group (camera refinement) takes no weight decay; its
    # schedule is held in tests/test_torch_port_pose_refine.py
    assert not optim.Optimizer(pf.named_parameters(),
                               dict(labels, **{'sigma_net.0': 'pose'})
                               ).decay['sigma_net.0']


def test_optimizer_gives_up_after_max_consecutive_nonfinite_steps():
    """optax.apply_if_finite: the update is applied once more than
    max_consecutive_errors non-finite steps come in a row (here 2, with
    the same chain as make_optimizer)."""
    params = _params()
    labels = JaxField.param_labels(params)
    inner = optax.chain(
        optax.masked(optax.add_decayed_weights(1e-6),
                     {k: jax.tree.map(lambda l: l == 'net', v)
                      for k, v in labels.items()}),
        optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-15),
        optax.scale_by_learning_rate(5e-3))
    tx = optax.apply_if_finite(inner, max_consecutive_errors=2)
    state, jparams = tx.init(params), params
    pf = _port_field(params)
    opt = optim.Optimizer(pf.named_parameters(), pf.param_labels(), lr=5e-3,
                          max_consecutive_errors=2)
    trees = _grad_trees(params, 5, nonfinite_at=-1)
    for i in (1, 2, 3):
        trees[i]['sigma_net'][0][0, 0] = np.inf
    for g in trees:
        updates, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(_flat(g))
    assert int(opt.state['count']) == int(state.inner_state[1].count) == 3
    ours = bridge.params_to_numpy(pf)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7,
                                   equal_nan=True)
    assert np.isnan(ours['sigma_net'][0]).any()  # the 4th step went in


@pytest.mark.parametrize('iters', [None, 20000, 3000])
def test_lr_schedule_matches_jax(iters):
    ours = optim.lr_schedule(5e-3, iters)
    ref = jax_optim.lr_schedule(5e-3, iters)
    if iters is None:
        assert ours == ref
        return
    for count in (0, 1, 999, 1000, 2500, 7000, 19999, 40000):
        _close(ours(count), ref(count), rtol=1e-6)
        _close(ours(torch.tensor(count)), ref(count), rtol=1e-6)


def test_packing_stays_in_the_graph_while_training():
    """Under autograd the heads and proposal weights are packed anew, in
    fp32 and in the graph (gradients reach the raw weights); the serving
    cache is neither used nor filled."""
    params = _params()
    pf = _port_field(params)
    rng = np.random.default_rng(14)
    x = torch.tensor(rng.uniform(-1, 1, (40, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(40, 3)).astype(np.float32)), dim=-1)
    with torch.no_grad():
        pf.all_heads(x, d)
    cached = pf._packs['heads'][2]
    assert not any(w.requires_grad for w in cached)
    sigma, rgb, logits, feats = pf.all_heads(x, d)
    loss = sigma.sum() + rgb.sum() + logits.sum() + feats.sum() \
        + pf.proposal_sigma(x).sum()
    loss.backward()
    assert set(pf._packs) == {'heads'}
    assert pf._packs['heads'][2] is cached
    for name, p in pf.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name


def _trainer_opts(**kw):
    return dict(num_steps=8, proposal_steps=16, perturb=False,
                stochastic_corners=0, **kw)


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """Both packages' trainers, 3 steps each from the same params and
    batches, each saving a checkpoint to its own workspace."""
    root = tmp_path_factory.mktemp('trainers')
    params = _params()
    batches = [_batch(seed=s) for s in (1, 2, 3)]
    jws, pws = str(root / 'jax'), str(root / 'port')
    jt = JaxSimpleTrainer('t', _jax_field(), lr=5e-3, iters=20000,
                          render_options=JaxRenderOptions(**_trainer_opts()),
                          workspace=jws)
    jp = jax.tree.map(jnp.asarray, params)
    jt.state = {'params': jp, 'opt_state': jt.tx.init(jp),
                'ema': jax.tree.map(jnp.copy, jp),
                'step': jnp.zeros((), jnp.int32)}
    pt = SimpleTrainer('t', _port_field(params), lr=5e-3, iters=20000,
                       render_options=RenderOptions(**_trainer_opts()),
                       workspace=pws)
    jax_losses, port_losses = [], []
    for b in batches:
        jax_losses.append({k: float(v) for k, v in
                           jt.train_iterations(iter([b]), 1).items()})
        port_losses.append({k: float(v) for k, v in
                            pt.train_iterations(iter([b]), 1).items()})
    jt.save_checkpoint('best')
    pt.save_checkpoint('best')
    return dict(jt=jt, pt=pt, jws=jws, pws=pws, params=params,
                jax_losses=jax_losses, port_losses=port_losses)


def test_simple_trainer_losses_match_jax(trained):
    """3 steps from the same params: every loss part within 1e-3. The
    params are not compared element by element: Adam's eps of 1e-15 moves
    every element with a non-zero gradient by about lr on the first step,
    so a gradient whose sign rounding decides gives parameters 2 lr
    apart."""
    for ours, ref in zip(trained['port_losses'], trained['jax_losses']):
        assert set(ours) == set(ref) and 'interlevel' in ours
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3, err_msg=k)
    assert trained['pt'].global_step == 3
    assert int(trained['pt'].optimizer.state['count']) == 3


def _eval_render(field_or_params, o, d, norms, jax_field=None):
    opts = dict(num_steps=8, proposal_steps=16)
    if jax_field is not None:
        return jax_render_rays(jax_field, field_or_params, o, d, norms,
                               options=JaxRenderOptions(**opts))
    with torch.no_grad():
        return render_rays(field_or_params, torch.tensor(o), torch.tensor(d),
                           torch.tensor(norms),
                           options=RenderOptions(**opts))


def test_port_checkpoint_loads_and_renders_in_jax(trained):
    pt = trained['pt']
    payload = jax_checkpoints.load_checkpoint(
        os.path.join(trained['pws'], 'checkpoints'))
    assert payload['global_step'] == 3 and payload['epoch'] == 0
    assert jax.tree.structure(payload['model']) == \
        jax.tree.structure(trained['params'])
    assert jax.tree.structure(payload['ema']) == \
        jax.tree.structure(trained['params'])
    o, d, norms = _rays(32, seed=20)
    ours = _eval_render(pt.field, o, d, norms)
    ref = _eval_render(payload['model'], o, d, norms, jax_field=_jax_field())
    for k in ('image', 'depth', 'semantic', 'weights_sum'):
        _close(ours[k], ref[k], atol=1e-5)
    # The JAX trainer resumes it, restarting the moments of this other
    # optimizer's state.
    jt = JaxSimpleTrainer('t', _jax_field(), lr=5e-3, iters=20000,
                          render_options=JaxRenderOptions(**_trainer_opts()),
                          workspace=trained['pws'])
    assert jt.global_step == 3
    assert int(jt.state['opt_state'].inner_state[1].count) == 0
    for a, b in zip(jax.tree.leaves(jt.state['ema']),
                    jax.tree.leaves(bridge.state_to_numpy(pt.ema))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_checkpoint_resumes_and_serves_in_the_port(trained):
    jt = trained['jt']
    pt = SimpleTrainer('t', _port_field(_params(seed=5)), lr=5e-3,
                       iters=20000,
                       render_options=RenderOptions(**_trainer_opts()),
                       workspace=trained['jws'])
    assert pt.global_step == 3
    assert int(pt.optimizer.state['count']) == 0  # optax state: restarted
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(pt.field)),
                    jax.tree.leaves(jt.state['params'])):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(bridge.state_to_numpy(pt.ema)),
                    jax.tree.leaves(jt.state['ema'])):
        np.testing.assert_array_equal(a, np.asarray(b))
    o, d, norms = _rays(32, seed=21)
    ref = _eval_render(jt.state['params'], o, d, norms,
                       jax_field=_jax_field())
    _close(_eval_render(pt.field, o, d, norms)['image'], ref['image'],
           atol=1e-5)
    _kernels.reset_launches()
    model = InferenceModel.from_checkpoint(
        Field(_port_config(), device='cpu'), trained['jws'], **STEPS,
        max_ray_batch=16)
    batch = {'rays_o': o.reshape(4, 8, 3), 'rays_d': d.reshape(4, 8, 3),
             'direction_norms': norms.reshape(4, 8, 1)}
    jm = JaxInferenceModel.from_checkpoint(_jax_field(), trained['jws'],
                                           **STEPS, max_ray_batch=16)
    _close(model.render(batch)['image'], jm.render(batch)['image'],
           atol=1e-5)
    assert sum(_kernels.launches.values()) == 0


def test_ema_is_taken_once_per_train_iterations(tmp_path):
    params = _params()
    pt = SimpleTrainer('t', _port_field(params), lr=5e-3, iters=20000,
                       render_options=RenderOptions(**_trainer_opts()),
                       workspace=str(tmp_path), ema_decay=0.9)
    before = {k: v.clone() for k, v in pt.ema.items()}
    pt.train(iter([_batch(seed=s) for s in (4, 5)]), epochs=1,
             iters_per_epoch=2)
    for name, p in pt.field.state_dict().items():
        torch.testing.assert_close(pt.ema[name],
                                   0.9 * before[name] + 0.1 * p)
    (record,) = [json.loads(line) for line in open(
        tmp_path / 'metrics.jsonl')]
    ref = JaxMetricsLogger(str(tmp_path / 'jax')).log(
        1, 2, {k: 0.0 for k in record if k not in ('epoch', 'step',
                                                    'wall_s')})
    assert set(record) == set(ref)
    assert record['epoch'] == 1 and record['step'] == 2
    assert {'rgb', 'depth', 'semantic', 'interlevel', 'total'} <= set(record)
    assert set(MetricsLogger(str(tmp_path / 'm')).log(1, 2, {'rgb': 0.5})) \
        == {'epoch', 'step', 'wall_s', 'rgb'}
    o, d, norms = _rays(64, seed=6)
    frame = {'rays_o': o.reshape(8, 8, 3), 'rays_d': d.reshape(8, 8, 3),
             'direction_norms': norms.reshape(8, 8, 1)}
    live = {k: v.clone() for k, v in pt.field.state_dict().items()}
    image, depth, _, _ = pt.test_step(frame, use_ema=True)
    assert image.shape == (8, 8, 3) and depth.shape == (8, 8)
    assert not torch.equal(image, pt.test_step(frame)[0])
    for name, p in pt.field.state_dict().items():  # live params restored
        assert torch.equal(p, live[name])


# Occupancy grids, TensorBoard events, the stochastic-corner estimator, the
# device mesh, and joint pose refinement and the interactive trainer on a
# mesh are ported (tests/test_torch_port_occupancy.py,
# tests/test_torch_port_cli.py, tests/test_torch_port_stochastic.py,
# tests/test_torch_port_parallel.py, tests/test_torch_port_parallel_pose.py).


STOCHASTIC_TRAINERS = [
    dict(render_options=RenderOptions(perturb=True, stochastic_corners=2,
                                      stochastic_residual=True)),
    dict(render_options=RenderOptions(perturb=True, stochastic_corners=4,
                                      stochastic_exact_levels=1)),
    dict(render_options=RenderOptions(perturb=True)),
    dict(render_options=RenderOptions(perturb=True, stochastic_corners=1,
                                      sampled_backward=0),
         exact_final_fraction=0.1)]


@pytest.mark.parametrize('kwargs', STOCHASTIC_TRAINERS)
def test_trainer_takes_the_stochastic_estimators(kwargs):
    """The stochastic-corner estimator's variants (residual, exact levels,
    the defaults, an exact tail) build a trainer whose phases are the JAX
    trainer's: the given options, then, with exact_final_fraction, exact
    gathers."""
    trainer = SimpleTrainer('t', _port_field(_params()), iters=1000, **kwargs)
    options = kwargs['render_options']
    assert trainer.step_options(0) == options
    tail = kwargs.get('exact_final_fraction')
    last = trainer.step_options(999)
    if tail:
        assert last == dataclasses.replace(options, stochastic_corners=0,
                                           sampled_backward=0,
                                           backward_points=1.0)
    else:
        assert last == options
