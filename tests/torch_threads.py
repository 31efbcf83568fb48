"""Imported by a test file for its effect: CPU torch runs one intra-op
thread in the process from then on, the fixtures that a test file builds
once for its module or session included.

At the tests' shapes torch's intra-op threads cost far more CPU than they
save, and the tier-1 suite's six workers already fill the cores:
``test_torch_semilag`` and ``test_torch_rk3_prefilter_layout`` alone on
an 8-core CPU took 95 s (721 s of user time) with torch's default 8
threads and 20 s (110 s) with one.
"""

import torch

torch.set_num_threads(1)
