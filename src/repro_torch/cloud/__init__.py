"""Cloud substrates: real object-store backends + serverless execution.

Port of src/repro/cloud/.

Two rungs above the in-process emulation (ROADMAP item 2):

  * `S3Backend` / `GCSBackend` — the repo's `StoreBackend` protocol over
    boto3 / gcsfs, behind gated imports (the deps are optional; missing
    ones raise ValueError naming the pip extra). `FakeS3Backend` speaks
    the same wire-level semantics in-process so CI exercises the cloud
    code paths hermetically.
  * `FunctionWorker` / `InvocationDriver` — a serverless execution mode
    running exactly one task per invocation with no shared state except
    the store, composed with the existing elastic driver so recovery,
    speculation, and byte-identity transfer with zero new code.
"""
from repro_torch.cloud.fake_s3 import FakeS3Backend
from repro_torch.cloud.function_worker import (FunctionWorker,
                                               InvocationDriver,
                                               InvocationRecord,
                                               event_from_reference, invoke,
                                               register_endpoint)
from repro_torch.cloud.remote import GCSBackend, S3Backend

__all__ = [
    "FakeS3Backend",
    "S3Backend",
    "GCSBackend",
    "FunctionWorker",
    "InvocationDriver",
    "InvocationRecord",
    "event_from_reference",
    "invoke",
    "register_endpoint",
]
