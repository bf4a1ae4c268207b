"""Task package: importing it fires every @register_algorithm decorator."""

from ..serve import serve  # noqa: F401 -- registers the `serve` task
from .dreamer_v1 import dreamer_v1 as _dreamer_v1  # noqa: F401 -- registers the `dreamer_v1` task
from .dreamer_v2 import dreamer_v2 as _dreamer_v2  # noqa: F401 -- registers the `dreamer_v2` task
from .dreamer_v3 import dreamer_v3 as _dreamer_v3  # noqa: F401 -- registers the `dreamer_v3` task
from .droq import droq as _droq  # noqa: F401 -- registers the `droq` task
from .ppo import ppo as _ppo  # noqa: F401 -- registers the `ppo` task
from .sac import sac as _sac  # noqa: F401 -- registers the `sac` task
