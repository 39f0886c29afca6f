"""One file per hand kernel of the program: the operations and bytes its
work needs, counted from the shapes and parameters of a wrapper call and
from the algorithm, never from how the kernel is written.

A file defines ``WRAPPER`` (the function of ``repro_torch.kernels.ops``
whose calls it counts), ``DEVICE_NAMES`` (substrings of the device kernel
names the profiler shows for it) and ``work(shape, *args, **kwargs) ->
(operations, bytes)``, called with the image argument's shape in place of
the image and the rest of the call's arguments as given.
"""
