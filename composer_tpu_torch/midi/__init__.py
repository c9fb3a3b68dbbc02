"""MIDI-like sequences and the event-token codec: the port's copy of
``composer_tpu/midi`` (events, vocabulary, MIDI reader and writer)."""

from composer_tpu_torch.midi.events import (
    Event,
    EventSequence,
    EventType,
    Note,
    NoteSequence,
    SustainPeriod,
    SustainPeriodEncodeMode,
)
from composer_tpu_torch.midi.vocab import Vocabulary

__all__ = [
    "Event",
    "EventSequence",
    "EventType",
    "Note",
    "NoteSequence",
    "SustainPeriod",
    "SustainPeriodEncodeMode",
    "Vocabulary",
]
