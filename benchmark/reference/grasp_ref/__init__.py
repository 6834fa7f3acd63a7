"""The frame route's plain reference: a frozen copy of the port's frame
function (``pipeline/frame.py`` ``select_grasp`` and everything it calls,
with the GraspPointCNN) at commit 8d152a04df5e.

Every hand-written kernel's wrapper here takes its plain PyTorch version
on any device (``kernels/*.py``), so the route runs as plain torch
operations, on the card or the CPU. Nothing here imports the port; the
only edits to the copied files are the package name in the imports, the
dropped kernel-build import and that dispatch.
"""
