"""Imports that register the built-in index types (side-effect imports),
the port of vearch_tpu/index/builtin.py."""

import vearch_tpu_torch.index.binary  # noqa: F401
import vearch_tpu_torch.index.disk  # noqa: F401
import vearch_tpu_torch.index.flat  # noqa: F401
import vearch_tpu_torch.index.hnsw  # noqa: F401
import vearch_tpu_torch.index.ivf  # noqa: F401
import vearch_tpu_torch.index.scann  # noqa: F401
import vearch_tpu_torch.index.sharded_flat  # noqa: F401
