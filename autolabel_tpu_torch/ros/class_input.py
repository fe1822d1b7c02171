"""Text-prompt class editor for the online (ROS) open-vocab node.

Counterpart of scripts/ros/class_input.py: a small window keeping an
ordered list of natural-language class prompts and publishing the
'|'-joined list on /autolabel/segmentation_classes whenever it changes;
row colours follow the segmentation palette; the first entry is always
the background prompt; Esc closes.

PromptList is the plain-python state (testable without Qt or ROS); main
draws it with a QListWidget and publishes through rospy, both imported
there.

    python -m autolabel_tpu_torch.ros.class_input
"""
import sys

from autolabel_tpu_torch.constants import COLORS
from autolabel_tpu_torch.utils import require

TOPIC = '/autolabel/segmentation_classes'
BACKGROUND_PROMPT = 'background; other'


class PromptList:
    """Ordered class prompts; index 0 is the background prompt."""

    def __init__(self, on_change=None):
        self._prompts = [BACKGROUND_PROMPT]
        self._on_change = on_change or (lambda encoded: None)

    @property
    def prompts(self):
        return list(self._prompts)

    def encoded(self):
        return '|'.join(self._prompts)

    def add(self, prompt):
        prompt = prompt.strip()
        if not prompt:
            return False
        self._prompts.append(prompt)
        self._on_change(self.encoded())
        return True

    def reset(self):
        self._prompts = [BACKGROUND_PROMPT]
        self._on_change(self.encoded())

    def color(self, index):
        return tuple(int(c) for c in COLORS[index % len(COLORS)])


def main():
    needs = 'the prompt editor'
    rospy = require('rospy', needs)
    QtCore = require('PyQt6.QtCore', needs)
    QtGui = require('PyQt6.QtGui', needs)
    QtWidgets = require('PyQt6.QtWidgets', needs)
    String = require('std_msgs.msg', needs).String

    rospy.init_node('segmentation_prompt_gui')
    publisher = rospy.Publisher(TOPIC, String, queue_size=1)

    app = QtWidgets.QApplication(sys.argv)

    window = QtWidgets.QWidget()
    window.setWindowTitle('Open-vocab classes')
    prompts = PromptList(
        on_change=lambda encoded: publisher.publish(String(encoded)))

    list_widget = QtWidgets.QListWidget()
    entry = QtWidgets.QLineEdit()
    entry.setPlaceholderText('Describe a class to segment…')
    add_button = QtWidgets.QPushButton('Add')
    reset_button = QtWidgets.QPushButton('Reset')

    def refresh():
        list_widget.clear()
        for i, prompt in enumerate(prompts.prompts):
            item = QtWidgets.QListWidgetItem(prompt)
            r, g, b = prompts.color(i)
            item.setBackground(QtGui.QColor(r, g, b))
            list_widget.addItem(item)

    def add_prompt():
        if prompts.add(entry.text()):
            entry.clear()
            refresh()

    def reset_prompts():
        prompts.reset()
        refresh()

    add_button.clicked.connect(add_prompt)
    entry.returnPressed.connect(add_prompt)
    reset_button.clicked.connect(reset_prompts)

    buttons = QtWidgets.QHBoxLayout()
    buttons.addWidget(entry)
    buttons.addWidget(add_button)
    buttons.addWidget(reset_button)
    layout = QtWidgets.QVBoxLayout(window)
    layout.addWidget(list_widget)
    layout.addLayout(buttons)

    shortcut = QtGui.QShortcut(QtGui.QKeySequence(
        QtCore.Qt.Key.Key_Escape), window)
    shortcut.activated.connect(window.close)

    refresh()
    prompts.reset()  # publish the initial class list once at startup
    window.show()
    app.exec()


if __name__ == '__main__':
    main()
