"""koord-runtime-proxy: the CRI interceptor (reference `pkg/runtimeproxy/`,
SURVEY.md 2.6) + the gRPC/UDS hook protocol (apis/runtime/v1alpha1/api.proto
analog, re-designed in `api.proto` here; `api_pb2.py` is generated by
`hack/gen_proto.sh`)."""

from koordinator_tpu_torch.runtimeproxy.server import (  # noqa: F401
    FailurePolicy,
    RuntimeProxy,
    FakeRuntimeBackend,
)
from koordinator_tpu_torch.runtimeproxy.hookclient import (  # noqa: F401
    HookClient,
    InProcessHookClient,
)
from koordinator_tpu_torch.runtimeproxy.criserver import (  # noqa: F401
    CRIClient,
    CRIProxyServer,
    FakeContainerdServer,
)
