"""Click helpers: the port's copy of ``composer_tpu/click_utils.py`` (parity:
composer/click_utils.py:10-83)."""

from __future__ import annotations

import re
from enum import EnumMeta

import click


class EnumType(click.Choice):
    """A click Choice over an Enum's member names, optionally case-insensitive."""

    def __init__(self, enum, casesensitive: bool = True):
        if not isinstance(enum, EnumMeta):
            raise TypeError("`enum` must be an Enum type")
        choices = list(enum.__members__)
        if not casesensitive:
            choices = [c.lower() for c in choices]
        self.enum = enum
        self.casesensitive = casesensitive
        super().__init__(sorted(set(choices)))

    def convert(self, value, param, ctx):
        if not self.casesensitive:
            value = value.lower()
        value = super().convert(value, param, ctx)
        for member in self.enum:
            name = member.name if self.casesensitive else member.name.lower()
            if name == value:
                return member
        raise click.BadParameter(f"'{value}' is not a member of {self.enum.__name__}")

    def get_metavar(self, param, ctx=None):
        word = self.enum.__name__
        word = re.sub(r"([A-Z]+)([A-Z][a-z])", r"\1_\2", word)
        word = re.sub(r"([a-z\d])([A-Z])", r"\1_\2", word)
        parts = word.replace("-", "_").lower().split("_")
        if parts and parts[-1] == "enum":
            parts.pop()
        return "_".join(parts).upper()
