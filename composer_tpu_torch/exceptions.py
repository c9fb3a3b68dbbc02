"""The port's exceptions: a copy of the ones ``composer_tpu/exceptions.py``
defines that the port raises."""


class ComposerError(Exception):
    """Base class for all framework errors."""


class InvalidParameterError(ComposerError):
    """Raised when an invalid parameter is given."""


class DatasetError(ComposerError):
    """Raised for dataset-related errors."""


class CheckpointError(ComposerError):
    """Raised when a checkpoint cannot be saved or restored."""


class EncodingError(ComposerError):
    """Raised when an encoded event-sequence file is malformed."""


class ServiceOverloadedError(ComposerError):
    """Raised when a serving queue is at capacity (HTTP 429)."""


class DeadlineExceededError(ComposerError):
    """Raised when a request's deadline expires before completion (HTTP 503)."""


class RequestCancelledError(ComposerError):
    """Raised to a waiter whose request was cancelled before completion."""
