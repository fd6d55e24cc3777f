"""Admin error types of the real-cluster adapter (port of the error half of
``cruise_control_tpu/executor/kafka_admin.py``).

The monitor's admin reads retry on :data:`RETRYABLE_ADMIN_ERRORS`, so the
error classes and the retryable/fatal split come first. The rest of the
module — ``KafkaAdminClusterClient``, the ``KafkaAdminWire`` protocol and
its mock — comes with the executor slice.
"""

from __future__ import annotations


class KafkaWireError(Exception):
    """A broker-side error for one key of an admin request. ``code`` is the
    Kafka protocol error name (``Errors`` enum name in the Java client)."""

    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}" if message else code)
        self.code = code


class AdminTimeoutError(RuntimeError):
    """REQUEST_TIMED_OUT — check broker/controller health, consider raising
    ``admin.client.request.timeout.ms`` (ref ExecutionUtils.java:584)."""


class AdminAuthorizationError(RuntimeError):
    """CLUSTER_AUTHORIZATION_FAILED (ref ExecutionUtils.java:659)."""


class AdminOperationError(RuntimeError):
    """An unclassified broker error (ref ExecutionUtils.java:590)."""


#: The canonical retryable/fatal split for raised admin errors: timeouts
#: are cluster/controller-side transients the shared
#: :class:`~cruise_control_tpu_torch.core.retry.RetryPolicy` may re-attempt;
#: authorization and unclassified operation errors are fatal — retrying
#: them can only repeat the failure (ref ExecutionUtils.java:584 vs :659).
RETRYABLE_ADMIN_ERRORS: tuple = (AdminTimeoutError,)
FATAL_ADMIN_ERRORS: tuple = (AdminAuthorizationError, AdminOperationError)
