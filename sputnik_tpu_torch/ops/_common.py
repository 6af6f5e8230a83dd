"""Padding arithmetic shared by the op layers."""

from __future__ import annotations

__all__ = ["round_up"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
