"""Quota controller (reference `pkg/quota-controller/`)."""

from koordinator_tpu_torch.quotacontroller.profile import QuotaProfileController  # noqa: F401
