"""The seven koordinator scheduler plugins (SURVEY.md section 2.2), host side.

Filter/Score math lives in `ops/` and is fused by `models/full_chain.py`; these
classes maintain the event-driven caches and perform per-binding effects
(Reserve/Unreserve/PreBind), mirroring the reference's split between
"incremental cache on events" and "pure function at schedule time".
"""

from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwarePlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.nodenumaresource import (  # noqa: F401
    NodeNUMAResourcePlugin,
)
from koordinator_tpu_torch.scheduler.plugins.reservation import ReservationPlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.coscheduling import CoschedulingPlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.elasticquota import ElasticQuotaPlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.deviceshare import DeviceSharePlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.defaultprebind import DefaultPreBindPlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.volumebinding import VolumeBindingPlugin  # noqa: F401

DEFAULT_PLUGINS = (
    LoadAwarePlugin,
    NodeNUMAResourcePlugin,
    ReservationPlugin,
    CoschedulingPlugin,
    ElasticQuotaPlugin,
    DeviceSharePlugin,
    VolumeBindingPlugin,
    DefaultPreBindPlugin,
)
