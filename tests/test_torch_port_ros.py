"""The port's ROS layer (utils/ros_utils.py, ros/node.py,
ros/class_input.py) against autolabel_tpu/utils/ros_utils.py and
scripts/ros/, on the CPU.

ROS 1 is no dependency of either package, so both nodes run under
tests/test_ros_node.py's stand-ins (_ros_mocks: subscribers, publishers
and services as callables, cv_bridge passing arrays through); everything
else runs as on a user's machine. Inputs come from seeded numpy
generators. Tolerances: SynchronizedStreams' matches, pose_matrix and
_quat_to_rotmat, the ingested frames' numbers, poses, images and depths,
the dropped messages, the debug log's files and PromptList are equal (bit
for bit, byte for byte); the fallback teacher's features and the prompt
encodings within 1e-6. The preview of an untrained tiny field (JAX's
params carried across) is held by the render limits of
tests/test_torch_port_backend.py: rgb within one uint8 step with its mean
within 5e-3, depth's mean and 99.9th percentile within 5e-3 and 5e-2 of
its largest value, class colours equal but where the top two similarities
lie within 1e-3 of the largest. Three steps of the node's trainers on the
same DynamicDataset batches, the port's fed JAX's draws: loss parts within
rtol 1e-3. The port's loop trains one 100-step burst on the CPU:
global_step 100, finite losses and previews, both threads ended by
stop().
"""
import importlib
import os
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

from autolabel_tpu.utils import ros_utils as jax_ros_utils
from autolabel_tpu_torch import bridge as port_bridge
from autolabel_tpu_torch.models.field import Field, FieldConfig
from autolabel_tpu_torch.ops.encoders import HashGridConfig
from autolabel_tpu_torch.ros import class_input, node as port_node
from autolabel_tpu_torch.utils import MissingDependency, ros_utils
from tests.test_ros_node import _image_msg, _pose_msg, _Registry, _ros_mocks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_DIM = 16
GRID = dict(n_levels=4, log2_hashmap_size=12, per_level_scale=1.6)
W, H = 32, 24
BATCH = 2048  # the node's DynamicDataset batch
PROMPTS = ['wall', 'red ball', 'floor', 'a chair']
ROS_MODULES = ('rospy', 'tf', 'cv_bridge', 'geometry_msgs',
               'geometry_msgs.msg', 'sensor_msgs', 'sensor_msgs.msg',
               'std_msgs', 'std_msgs.msg', 'std_srvs', 'std_srvs.srv')


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- ros_utils ----------------------------------------------------------------

class _Stamp:

    def __init__(self, t):
        self.t = t

    def to_sec(self):
        return self.t


def _stream(seed, n=300):
    """(name, msg) in arrival order: stamps on a 1/240 s clock plus
    offsets that put pairs exactly at the 1/60 s threshold, within it,
    beyond it, and at equal stamps (ties)."""
    rng = np.random.default_rng(seed)
    offsets = np.array([0.0, 0.0, 1 / 60, -1 / 60, 1 / 120, 0.01, -0.03,
                        0.05, 1 / 60 + 1e-9])
    out = []
    for k in range(n):
        t = k / 240 + offsets[rng.integers(0, len(offsets))]
        name = ('rgb', 'depth', 'pose')[rng.integers(0, 3)]
        out.append((name, types.SimpleNamespace(
            header=types.SimpleNamespace(stamp=_Stamp(t)), index=k)))
    return out


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('max_size', [1, 3, 10])
def test_synchronized_streams_match_jax(seed, max_size):
    names = ('rgb', 'depth', 'pose')
    ours = ros_utils.SynchronizedStreams(names, 1.0 / 60.0, max_size)
    ref = jax_ros_utils.SynchronizedStreams(names, 1.0 / 60.0, max_size)
    got, want = [], []
    for name, msg in _stream(seed):
        for streams, out in ((ours, got), (ref, want)):
            m = streams.offer(name, msg)
            out.append(None if m is None else
                       {k: v.index for k, v in m.items()})
        assert [len(b) for b in ours.buffers.values()] == \
            [len(b) for b in ref.buffers.values()]
    assert got == want
    assert any(m is None for m in got) and any(m is not None for m in got)
    assert all(len(b) == max_size for b in ours.buffers.values())  # evicted


def test_message_buffer_closest_matches_jax():
    rng = np.random.default_rng(5)
    ours, ref = ros_utils.MessageBuffer(0.02, 4), \
        jax_ros_utils.MessageBuffer(0.02, 4)
    for k, t in enumerate(np.round(rng.uniform(0, 0.2, 40), 2)):
        msg = types.SimpleNamespace(
            header=types.SimpleNamespace(stamp=_Stamp(float(t))), index=k)
        ours.add_message(msg)
        ref.add_message(msg)
        for query in (t, t + 0.02, t - 0.021, t + 0.01):
            a, b = ours.closest(_Stamp(query)), ref.closest(_Stamp(query))
            assert (a and a.index) == (b and b.index)
    assert len(ours) == len(ref) == 4


def _quats(seed):
    rng = np.random.default_rng(seed)
    quats = [rng.normal(size=4) * scale
             for scale in (1.0, 1e-3, 1e3, 1e-30) for _ in range(4)]
    quats += [q / np.linalg.norm(q) for q in quats[:4]]
    quats += [np.zeros(4), np.array([0.0, 0.0, 0.0, 1.0]),
              np.array([1.0, 0.0, 0.0, 0.0]), np.array([0.0, -0.0, 0.0,
                                                        -2.0])]
    return quats, rng


@pytest.mark.parametrize('seed', [0, 1])
def test_pose_matrix_bit_equal(seed):
    quats, rng = _quats(seed)
    for q in quats:
        q = [float(v) for v in q]
        np.testing.assert_array_equal(ros_utils._quat_to_rotmat(*q),
                                      jax_ros_utils._quat_to_rotmat(*q))
        msg = _pose_msg(0.0, tuple(float(v) for v in rng.normal(size=3)),
                        tuple(q))
        np.testing.assert_array_equal(ros_utils.pose_matrix(msg),
                                      jax_ros_utils.pose_matrix(msg))


# -- the node's wiring --------------------------------------------------------

def _install(monkeypatch):
    """Fresh ROS stand-ins in sys.modules, with their registry."""
    registry = _Registry()
    mocks = _ros_mocks(registry)
    mocks['rospy'].init_node = lambda name: registry.__dict__.setdefault(
        'inits', []).append(name)
    for name, mod in mocks.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return registry


@pytest.fixture
def nodes(monkeypatch):
    """scripts/ros/node.py imported under one set of stand-ins (its
    module-level imports bind them), then a second set installed for the
    port's node, which imports ROS at its calls."""
    jax_registry = _install(monkeypatch)
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    sys.modules.pop('ros.node', None)
    try:
        jax_node = importlib.import_module('ros.node')
        yield jax_registry, jax_node, _install(monkeypatch)
    finally:
        sys.modules.pop('ros.node', None)
        sys.path.remove(os.path.join(REPO, 'scripts'))


def _spy_loop(with_device):

    class SpyLoop:
        def __init__(self, bridge, bound, device=None):
            assert with_device or device is None
            self.bridge = bridge
            self.bound = bound
            self.device = device
            self.frames = []
            self.cameras = []
            self.training = True
            self.odometry_pose = None
            self.stopped = False

        def set_camera(self, msg):
            self.cameras.append(msg)

        def add_frame(self, frame):
            self.frames.append(frame)

        def stop(self):
            self.stopped = True

    return SpyLoop


def _messages(seed):
    """One sequence of the node's traffic: (topic or service, message)."""
    rng = np.random.default_rng(seed)
    out = [('/slam/camera_info', types.SimpleNamespace(
        K=[100.0, 0, 16.0, 0, 100.0, 12.0, 0, 0, 1.0], width=W, height=H))]

    def triple(t, seq, dt_depth=0.004, dt_pose=0.008, pos=None):
        rgb = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        depth = rng.integers(500, 4000, (H, W)).astype(np.uint16)
        quat = rng.normal(size=4)
        pos = tuple(rng.normal(size=3)) if pos is None else pos
        return [('/slam/rgb', _image_msg(t, rgb, seq=seq)),
                ('/slam/depth', _image_msg(t + dt_depth, depth)),
                ('/slam/keyframe', _pose_msg(t + dt_pose, pos, tuple(quat)))]

    for i in range(4):  # in sync
        out += triple(1.0 + i, 10 + i)
    out += triple(6.0, 20, dt_depth=0.5, dt_pose=1.0)  # never matched
    out += triple(8.0, 21, dt_depth=0.03, dt_pose=0.015)  # rgb-depth warned
    out += triple(9.0, 22, dt_depth=0.0, dt_pose=0.0)  # ties
    out.append(('/slam/odometry', _pose_msg(9.5, (0.0, 0.5, 1.0),
                                            (0.1, 0.2, 0.3, 0.9))))
    out.append(('/autolabel/segmentation_classes',
                types.SimpleNamespace(data='|'.join(PROMPTS))))
    out.append(('/autolabel/train', None))
    out.append(('/autolabel/pause', None))
    out += triple(10.0, 30)  # paused: dropped
    out.append(('/autolabel/pause', None))
    out += triple(11.0, 31)
    out.append(('/autolabel/train', None))
    return out


def _drive(registry, messages):
    for topic, msg in messages:
        if topic in registry.services:
            assert registry.services[topic](msg) == []
        elif topic in registry.subs:
            registry.subs[topic](msg)


def _flags(log):
    return port_node.read_args(['--features', 'lseg', '--allow-fallback',
                                '--log', log])


def test_node_wiring_matches_scripts_node(nodes, monkeypatch, tmp_path):
    jax_registry, jax_node, registry = nodes
    monkeypatch.setattr(jax_node, 'TrainingLoop', _spy_loop(False))
    monkeypatch.setattr(port_node, 'TrainingLoop', _spy_loop(True))
    logs = {k: str(tmp_path / k) for k in ('jax', 'port')}
    ref = jax_node.AutolabelNode(types.SimpleNamespace(
        features='lseg', checkpoint=None, allow_fallback=True,
        log=logs['jax'], bound=2.5))
    ours = port_node.AutolabelNode(_flags(logs['port']), device='cpu')
    assert ours.training_loop.device == torch.device('cpu')
    assert sorted(registry.subs) == sorted(jax_registry.subs)
    assert sorted(registry.services) == sorted(jax_registry.services)
    np.testing.assert_allclose(ours.bridge.prompt_features,
                               ref.bridge.prompt_features, rtol=0, atol=1e-6)

    messages = _messages(0)
    _drive(jax_registry, messages)
    _drive(registry, messages)

    for registry_ in (registry, jax_registry):
        assert '/slam/camera_info' not in registry_.subs
    loop, ref_loop = ours.training_loop, ref.training_loop
    assert len(loop.cameras) == len(ref_loop.cameras) == 1
    assert [f.num for f in loop.frames] == [f.num for f in ref_loop.frames] \
        == [10, 11, 12, 13, 21, 22, 31]
    for got, want in zip(loop.frames, ref_loop.frames):
        np.testing.assert_array_equal(got.T_CW, want.T_CW)
        np.testing.assert_array_equal(got.image, want.image)
        np.testing.assert_array_equal(got.depth, want.depth)
        assert got.features.shape == want.features.shape == (H // 2, W // 2,
                                                            512)
        assert got.features.dtype == want.features.dtype
        np.testing.assert_allclose(got.features, want.features, rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(loop.odometry_pose, ref_loop.odometry_pose)
    assert ours.bridge.prompt_features.shape == (len(PROMPTS), 512)
    np.testing.assert_allclose(ours.bridge.prompt_features,
                               ref.bridge.prompt_features, rtol=0, atol=1e-6)
    assert loop.training == ref_loop.training is True  # toggled twice
    assert ours.reading == ref.reading is True

    # The debug log: the same files, byte for byte.
    for sub, ext in (('rgb', 'jpg'), ('depth', 'png'), ('pose', 'txt')):
        names = sorted(os.listdir(os.path.join(logs['port'], sub)))
        assert names == sorted(os.listdir(os.path.join(logs['jax'], sub)))
        assert names == [f'{n:06d}.{ext}' for n in (10, 11, 12, 13, 21, 22,
                                                    31)]
        for name in names:
            with open(os.path.join(logs['port'], sub, name), 'rb') as f, \
                    open(os.path.join(logs['jax'], sub, name), 'rb') as g:
                assert f.read() == g.read(), (sub, name)
    ours.stop()
    assert loop.stopped


def test_node_device_and_missing_ros(monkeypatch, tmp_path):
    """No card: the node raises unless given device='cpu'. Without ROS the
    node and the prompt editor raise naming the module."""
    flags = _flags(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            port_node.AutolabelNode(flags)
        with pytest.raises(RuntimeError, match='CUDA'):
            port_node.TrainingLoop(None, 2.5)
    for name in ROS_MODULES:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(MissingDependency, match='tf'):
        port_node.AutolabelNode(flags, device='cpu')
    with pytest.raises(MissingDependency, match='rospy'):
        port_node.main(['--allow-fallback'], device='cpu')
    with pytest.raises(MissingDependency, match='rospy'):
        class_input.main()


def test_node_main_raises_the_constructors_error(monkeypatch):
    """main's finally stops only a node that was built: a failing
    constructor's own error reaches the caller (scripts/ros/node.py's
    main hides it behind a NameError)."""
    registry = _install(monkeypatch)
    with pytest.raises(NotImplementedError, match='nope'):
        port_node.main(['--features', 'nope'], device='cpu')
    assert registry.inits == ['autolabel']

    stopped = []
    monkeypatch.setattr(port_node, 'TrainingLoop', _spy_loop(True))
    monkeypatch.setattr(port_node.AutolabelNode, 'stop',
                        lambda self: stopped.append(self))
    port_node.main(['--allow-fallback'], device='cpu')  # spin returns
    assert len(stopped) == 1


def test_read_args_match_scripts_node(nodes, monkeypatch):
    _, jax_node, _ = nodes
    for argv in ([], ['--features', 'dino', '--checkpoint', 'c.pth',
                      '--allow-fallback', '--log', 'l', '-b', '1.25']):
        monkeypatch.setattr(sys, 'argv', ['node.py'] + argv)
        assert vars(port_node.read_args(argv)) == vars(jax_node.read_args())
    assert port_node.RENDER_INTRINSICS == jax_node.RENDER_INTRINSICS
    assert port_node.AutolabelNode.SYNC_THRESHOLD == \
        jax_node.AutolabelNode.SYNC_THRESHOLD


# -- the node's preview and burst ---------------------------------------------

def _tiny(monkeypatch, module, create):
    monkeypatch.setattr(module.model_utils, 'create_model', create)
    real = module.RenderOptions
    monkeypatch.setattr(module, 'RenderOptions',
                        lambda **kw: real(**{**kw, 'num_steps': 16}))
    monkeypatch.setattr(module, 'RENDER_INTRINSICS',
                        (20.0, 20.0, W / 2, H / 2))


def _port_create(min_bounds, max_bounds, n_classes, opt, device=None):
    from autolabel_tpu_torch import model_utils
    return Field(FieldConfig(
        encoding='hg+freq', hidden_dim=32, hidden_dim_color=32,
        hidden_dim_semantic=FEATURE_DIM, semantic_classes=n_classes,
        bound=model_utils.compute_bound(min_bounds, max_bounds),
        grid=HashGridConfig(**GRID)), device=device)


def _jax_create(min_bounds, max_bounds, n_classes, opt):
    from autolabel_tpu import model_utils
    from autolabel_tpu.models.field import Field as JField
    from autolabel_tpu.models.field import FieldConfig as JConfig
    from autolabel_tpu.ops.encoders import HashGridConfig as JGrid
    return JField(JConfig(
        encoding='hg+freq', hidden_dim=32, hidden_dim_color=32,
        hidden_dim_semantic=FEATURE_DIM, semantic_classes=n_classes,
        bound=model_utils.compute_bound(min_bounds, max_bounds),
        grid=JGrid(**GRID), grid_impl='xla'))


class _Recorder:
    """The feature maps and depths a loop publishes, kept as it gives them
    to its bridge and to visualize_depth."""

    def __init__(self, monkeypatch, module, bridge):
        self.features, self.depths = [], []
        publish = bridge.features_to_message

        def features_to_message(feature_map):
            self.features.append(np.array(feature_map))
            return publish(feature_map)

        bridge.features_to_message = features_to_message
        visualize = module.visualization.visualize_depth

        def visualize_depth(depth, maxdepth=None):
            self.depths.append(np.array(depth))
            return visualize(depth, maxdepth=maxdepth)

        monkeypatch.setattr(module, 'visualization', types.SimpleNamespace(
            visualize_depth=visualize_depth))


def _frames(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T_CW = np.eye(4)
        T_CW[:3, 3] = [0.01 * i, 0.0, -1.0]
        out.append((i, T_CW, rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
                    rng.integers(900, 1100, (H, W)).astype(np.uint16),
                    rng.normal(size=(H // 8, W // 8, FEATURE_DIM))
                    .astype(np.float32)))
    return out


def _arm(loop, module, frames):
    loop.render_resolution = (W, H)
    loop.pixel_indices = np.arange(W * H)
    loop.set_camera(types.SimpleNamespace(
        K=[20.0, 0, W / 2, 0, 20.0, H / 2, 0, 0, 1.0], width=W, height=H))
    for frame in frames:
        loop.add_frame(module.Frame(*frame))


def _wait_published(registries, cond=lambda: True, timeout=240):
    topics = ('/autolabel/image', '/autolabel/features', '/autolabel/depth')
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(r.pubs.get(t) for r in registries for t in topics) and cond():
            return
        time.sleep(0.05)
    pytest.fail('the training loop never published previews')


def _near_ties(sim, share=1e-3):
    top2 = np.sort(sim, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= share * np.abs(sim).max()


def test_preview_matches_scripts_node(nodes, monkeypatch):
    """Both TrainingLoops on one tiny field (JAX's params, the table drawn
    from N(0, 0.5)), 5 frames (no burst), the same odometry pose: the first
    published image, depth and class colouring agree."""
    jax_registry, jax_node, registry = nodes
    _tiny(monkeypatch, jax_node, _jax_create)
    _tiny(monkeypatch, port_node, _port_create)
    bridges = {}
    loops = {}
    try:
        for tag, module, kw in (('jax', jax_node, {}),
                                ('port', port_node, {'device': 'cpu'})):
            bridges[tag] = module.Bridge('lseg', None, allow_fallback=True,
                                         **kw)
            bridges[tag].set_prompts(PROMPTS)
        rec = {tag: _Recorder(monkeypatch, module, bridges[tag])
               for tag, module in (('jax', jax_node), ('port', port_node))}
        loops['jax'] = jax_node.TrainingLoop(bridges['jax'], 1.5)
        loops['port'] = port_node.TrainingLoop(bridges['port'], 1.5,
                                               device='cpu')
        jt = loops['jax'].trainer
        params = jax.tree.map(np.array, jt.state['params'])
        params['encoder']['grid'] = np.random.default_rng(0).normal(
            0.0, 0.5, params['encoder']['grid'].shape).astype(np.float32)
        jt.state = dict(jt.state, params=jax.tree.map(jax.numpy.asarray,
                                                      params))
        port_bridge.load_params(loops['port'].field, params)
        frames = _frames(5)
        pose = np.eye(4)
        pose[:3, 3] = [0.1, -0.05, 0.2]
        for tag, module in (('jax', jax_node), ('port', port_node)):
            _arm(loops[tag], module, frames)
            loops[tag].odometry_pose = pose
        _wait_published((jax_registry, registry))
    finally:
        for loop in loops.values():
            loop.stop()
    assert loops['port'].trainer.global_step == 0  # 5 frames: no burst

    image = registry.pubs['/autolabel/image'][0].array
    want = jax_registry.pubs['/autolabel/image'][0].array
    assert image.shape == (H, W, 3) and image.dtype == np.uint8
    diff = np.abs(image.astype(int) - want.astype(int))
    assert diff.max() <= 1 and diff.mean() / 255 <= 5e-3
    assert 20 < want.mean() < 235  # the table draws a visible scene

    depth, want_depth = rec['port'].depths[0], rec['jax'].depths[0]
    err = np.abs(depth - want_depth)
    scale = np.abs(want_depth).max()
    assert err.mean() <= 5e-3 * scale
    assert np.percentile(err, 99.9) <= 5e-2 * scale
    assert registry.pubs['/autolabel/depth'][0].array.shape == (H, W, 3)

    feats = rec['port'].features[0]
    assert feats.shape == (H, W, FEATURE_DIM) and np.isfinite(feats).all()
    colours = registry.pubs['/autolabel/features'][0].array
    want_colours = jax_registry.pubs['/autolabel/features'][0].array
    assert colours.shape == (H, W, 3) and colours.dtype == np.uint8
    norms = np.linalg.norm(rec['jax'].features[0], axis=-1, keepdims=True)
    sim = (rec['jax'].features[0] / np.maximum(norms, 1e-9)) @ \
        bridges['jax'].prompt_features[:, :FEATURE_DIM].T
    firm = ~_near_ties(sim)
    np.testing.assert_array_equal(colours[firm], want_colours[firm])
    assert firm.mean() > 0.9
    palette = {tuple(c) for c in
               (port_node.COLORS[:len(PROMPTS)] * 255).astype(np.uint8)}
    assert {tuple(c) for c in colours.reshape(-1, 3)} <= palette


def test_burst_trains_and_publishes(monkeypatch):
    """The port's loop on the tiny field: 6 frames start a 100-step burst
    on the loop's thread; previews follow it; stop() ends both threads."""
    registry = _install(monkeypatch)
    _tiny(monkeypatch, port_node, _port_create)

    class StubBridge:
        def image_to_message(self, array):
            return array

        def features_to_message(self, feature_map):
            return feature_map

    losses = []
    train_iterations = port_node.SimpleTrainer.train_iterations

    def recorded(self, dataset, iterations, progress=True):
        out = train_iterations(self, dataset, iterations, progress)
        losses.append({k: float(v) for k, v in out.items()})
        return out

    monkeypatch.setattr(port_node.SimpleTrainer, 'train_iterations',
                        recorded)
    loop = port_node.TrainingLoop(StubBridge(), 1.5, device='cpu')
    try:
        _arm(loop, port_node, _frames(6, seed=2))
        loop.odometry_pose = np.eye(4)
        _wait_published((registry,), lambda: bool(losses))
    finally:
        loop.stop()
    assert not loop.training_thread.is_alive()
    assert not loop.dataset._prefetch_thread.is_alive()
    assert loop.trainer.global_step == 100 * len(losses) >= 100
    assert all(np.isfinite(v) for parts in losses for v in parts.values())
    image = registry.pubs['/autolabel/image'][-1]
    assert image.shape == (H, W, 3) and image.dtype == np.uint8
    assert registry.pubs['/autolabel/depth'][-1].shape == (H, W, 3)
    features = registry.pubs['/autolabel/features'][-1]
    assert features.shape == (H, W, FEATURE_DIM)
    assert np.isfinite(features).all()
    assert loop.field.device == torch.device('cpu')


def _node_draws(step, options, levels):
    """The uniforms JAX's SimpleTrainer step number `step` draws from
    fold_in(PRNGKey(seed + 1), step), seed 0 (trainer.py:_make_step,
    renderer.py:212): u_coarse, and u_enc from k_enc as the stochastic
    trilinear encode draws it."""
    from autolabel_tpu_torch.ops import encoders
    from tests.test_torch_port_stochastic import _jax_uniforms
    key = jax.random.fold_in(jax.random.PRNGKey(1), step)
    _, k_coarse, _, k_enc = jax.random.split(key, 4)
    draws = {'u_coarse': np.asarray(jax.random.uniform(
        k_coarse, (BATCH, options.num_steps)))}
    draws['u_enc'] = _jax_uniforms(k_enc, encoders.uniform_shape(
        levels, BATCH * options.num_steps, n_samples=max(
            1, options.stochastic_corners),
        residual=options.stochastic_residual))
    return {k: torch.tensor(v) for k, v in draws.items()}


def test_burst_steps_match_scripts_node(nodes, monkeypatch):
    """Three steps of each loop's trainer (the node's loss and render
    options) on the same DynamicDataset batches, the port's with JAX's
    draws, from JAX's params: the loss parts within rtol 1e-3 (Adam moves
    a parameter by about 2 lr where a gradient's sign is decided by
    rounding)."""
    from autolabel_tpu_torch.core.dataset import DynamicDataset
    from autolabel_tpu_torch.utils import Camera
    _, jax_node, _ = nodes
    _tiny(monkeypatch, jax_node, _jax_create)
    _tiny(monkeypatch, port_node, _port_create)
    loops = {}
    dataset = DynamicDataset(BATCH, Camera(np.array(
        [[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1.0]]), (W, H)))
    dataset.stop()  # batches drawn here, in order, from a seeded rng
    dataset.rng = np.random.default_rng(0)
    try:
        loops['jax'] = jax_node.TrainingLoop(None, 1.5)
        loops['port'] = port_node.TrainingLoop(None, 1.5, device='cpu')
        jt, pt = loops['jax'].trainer, loops['port'].trainer
        params = jax.tree.map(np.array, jt.state['params'])
        params['encoder']['grid'] = np.random.default_rng(0).normal(
            0.0, 0.5, params['encoder']['grid'].shape).astype(np.float32)
        jt.state = dict(jt.state, params=jax.tree.map(jax.numpy.asarray,
                                                      params))
        port_bridge.load_params(pt.field, params)
        for frame in _frames(6, seed=3):
            dataset.add_frame(*frame[1:])
        batches = [dataset._next_train() for _ in range(3)]
        levels = GRID['n_levels']
        for step, batch in enumerate(batches):
            want = jt.train_iterations(iter([batch]), 1)
            got = pt.train_step(batch, _node_draws(step, pt.render_options,
                                                   levels))
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_allclose(float(got[key]), float(want[key]),
                                           rtol=1e-3, atol=1e-7,
                                           err_msg=f'step {step} {key}')
    finally:
        for loop in loops.values():
            loop.stop()


# -- the prompt editor ----------------------------------------------------------

def test_prompt_list_matches_scripts_class_input():
    sys.path.insert(0, REPO)
    from scripts.ros import class_input as jax_class_input
    assert (class_input.TOPIC, class_input.BACKGROUND_PROMPT) == (
        jax_class_input.TOPIC, jax_class_input.BACKGROUND_PROMPT)
    rng = np.random.default_rng(3)
    published, want_published = [], []
    ours = class_input.PromptList(on_change=published.append)
    ref = jax_class_input.PromptList(on_change=want_published.append)
    words = ['a red chair', '  ', '', 'lamp ', '\tdesk\n', 'wall',
             'the floor']
    for step in range(60):
        if rng.random() < 0.1:
            ours.reset(), ref.reset()
        else:
            prompt = words[rng.integers(0, len(words))]
            assert ours.add(prompt) == ref.add(prompt)
        assert ours.prompts == ref.prompts
        assert ours.encoded() == ref.encoded()
    assert published == want_published and len(published) > 20
    assert [ours.color(i) for i in range(90)] == \
        [ref.color(i) for i in range(90)]
    assert class_input.PromptList().prompts == [class_input.BACKGROUND_PROMPT]
    # tests/test_gui.py::test_prompt_list, on the port
    published = []
    prompts = class_input.PromptList(on_change=published.append)
    assert prompts.add('a red chair')
    assert not prompts.add('   ')
    assert published == [f'{class_input.BACKGROUND_PROMPT}|a red chair']
    prompts.reset()
    assert published[-1] == class_input.BACKGROUND_PROMPT
    assert len(prompts.color(0)) == 3
