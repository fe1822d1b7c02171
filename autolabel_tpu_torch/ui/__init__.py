"""The labelling front end: the annotation state (annotations.py), the
paint canvas (canvas.py) and the window (window.py, run as
`python -m autolabel_tpu_torch.gui <scene>`).

PyQt6 and cv2 are not dependencies of the port: they are imported at the
call that needs them, and a missing one raises naming itself. The Qt
widget classes are made on first use (a module __getattr__), against the
PyQt6 modules present then.
"""
from autolabel_tpu_torch.utils import require


def qt_modules():
    """PyQt6's (QtCore, QtGui, QtWidgets), imported at the call."""
    return tuple(require(f'PyQt6.{name}', 'the labelling window')
                 for name in ('QtCore', 'QtGui', 'QtWidgets'))


def lazy_qt_classes(build):
    """A function returning build(QtCore, QtGui, QtWidgets)'s dict of
    classes, made on its first call and again when PyQt6's modules in
    sys.modules have changed since."""
    made = {}

    def classes():
        modules = qt_modules()
        if made.get('modules') is None or any(
                a is not b for a, b in zip(made['modules'], modules)):
            made['classes'] = build(*modules)
            made['modules'] = modules
        return made['classes']

    return classes
