"""Import alias for the ``4paradigm-k8s-device-plugin_tpu_torch`` package.

The on-disk package directory name contains characters that are not legal
in a Python identifier, so this tiny shim re-points the ``vtpu_torch``
package's search path at that directory.  All code lives under
``4paradigm-k8s-device-plugin_tpu_torch/``; import it as::

    from vtpu_torch.models import transformer
    from vtpu_torch.ops.flash_attention import flash_attention
"""

import os as _os

__version__ = "0.1.0"

_here = _os.path.dirname(_os.path.abspath(__file__))
_pkg_dir = _os.path.join(_os.path.dirname(_here),
                         "4paradigm-k8s-device-plugin_tpu_torch")

# Re-point the package search path at the real source tree.
__path__ = [_pkg_dir]
