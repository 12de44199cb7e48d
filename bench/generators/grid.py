"""The pixel-grid generator: ``h`` x ``w`` pixels, 4-neighbours plus the
long-range offsets, costs drawn around a planted segmentation. ``make``
is the frozen :func:`ramabench.instances.grid`, the program's
``grid_instance`` draw for draw."""
from ramabench import instances

SMALL = dict(h=10, w=12, noise=0.4, n_segments=3, long_range=True)

make = instances.grid
