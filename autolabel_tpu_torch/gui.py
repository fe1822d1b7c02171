"""The interactive labeller's process side: its flags, the backend child's
entry and the client that owns the child.

Counterpart of the non-Qt part of scripts/gui.py (read_args,
_run_backend, BackendClient). The window itself (the Qt front end with
ui/canvas.py and ui/annotations.py) is not ported: run scripts/gui.py for
it. The child is started with the 'spawn' method: a process that has used
CUDA cannot fork a child that uses it.
"""
import multiprocessing
import signal
import time

from autolabel_tpu_torch import model_utils

STOP_TIMEOUT_S = 60.0  # a child still alive this long after SIGTERM is killed


def read_args(argv=None):
    """scripts/gui.py's flags and defaults; argv defaults to
    sys.argv[1:]."""
    parser = model_utils.model_flag_parser()
    parser.set_defaults(lr=1e-4)
    parser.add_argument('scene')
    parser.add_argument('--batch-size', type=int, default=4096)
    parser.add_argument('--dry', action='store_true',
                        help="Run the UI without the NeRF backend.")
    parser.add_argument('--baked-preview', action='store_true',
                        help="Serve preview renders from a periodically "
                        "re-baked splat cache (millisecond frames) "
                        "instead of full volumetric renders.")
    parser.add_argument('--rebake-every', type=int, default=2000,
                        help="Training steps between preview re-bakes.")
    parser.add_argument('--occupancy-grid', action='store_true',
                        help="Maintain an occupancy grid masking density "
                        "in empty/unobserved cells during training.")
    return parser.parse_args(argv)


def run_backend(flags, connection, device=None):
    """Child-process entry: train forever, serving preview requests, until
    SIGTERM. Returns the stopped TrainingLoop."""
    from autolabel_tpu_torch.backend import TrainingLoop
    loop = TrainingLoop(flags.scene, flags, connection, device=device)
    signal.signal(signal.SIGTERM, loop.shutdown)
    loop.run()
    return loop


class BackendClient:
    """Owns the trainer child process and its duplex pipe.

    Messages out: ('get_image', idx) / ('update_image', idx) /
    ('checkpoint', None). Messages in: ('image', payload). Stale previews
    (for a frame the user already navigated away from) are discarded
    here, not in the window. device goes to the child (None: the card);
    target is the child's entry, run_backend unless a caller wraps it.
    """

    def __init__(self, flags, on_preview, device=None, target=run_backend):
        self.on_preview = on_preview
        self._current_frame = 0
        self._process = None
        self._pipe = None
        if not flags.dry:
            context = multiprocessing.get_context('spawn')
            self._pipe, child_end = context.Pipe()
            self._process = context.Process(
                target=target, args=(flags, child_end, device))
            self._process.start()

    @property
    def live(self):
        return self._pipe is not None

    def request_preview(self, frame_index):
        self._current_frame = frame_index
        self._send(('get_image', frame_index))

    def labels_changed(self, frame_index):
        self._send(('update_image', frame_index))

    def save_checkpoint(self):
        self._send(('checkpoint', None))

    def poll(self):
        """Drain the pipe; forward the newest preview for the current
        frame to on_preview."""
        if not self.live:
            return
        while self._pipe.poll():
            kind, payload = self._pipe.recv()
            if kind == 'image' and \
                    payload['image_index'] == self._current_frame:
                self.on_preview(payload)

    def stop(self):
        """Terminate the child and join it, draining the pipe meanwhile (a
        child blocked sending a preview ends only once it is read); kill it
        after STOP_TIMEOUT_S. Returns its exit code."""
        if self._process is None:
            return None
        self._process.terminate()
        deadline = time.monotonic() + STOP_TIMEOUT_S
        while self._process.is_alive() and time.monotonic() < deadline:
            try:
                while self._pipe.poll():
                    self._pipe.recv()
            except EOFError:  # the child has closed its end
                pass
            self._process.join(0.05)
        if self._process.is_alive():
            self._process.kill()
            self._process.join()
        exitcode = self._process.exitcode
        self._process = None
        return exitcode

    def _send(self, message):
        if self.live:
            self._pipe.send(message)
