"""Admission webhooks (analog of reference `pkg/webhook/`, SURVEY.md 2.4)."""

from koordinator_tpu_torch.webhook.server import AdmissionServer, AdmissionError  # noqa: F401
