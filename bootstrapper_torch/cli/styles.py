"""Styled CLI output: per-command colour palettes.

Same UX capability as the reference (reference
``bootstrapper/styles.py:4-48``): each workflow stage prints/prompts in
its own colour so interleaved logs stay readable.
"""

from __future__ import annotations

import click

STYLES = {
    "prepare": {"fg": "cyan"},
    "train": {"fg": "green"},
    "predict": {"fg": "yellow"},
    "segment": {"fg": "magenta"},
    "evaluate": {"fg": "blue"},
    "filter": {"fg": "red"},
    "view": {"fg": "white"},
    "utils": {"fg": "bright_black"},
    "doctor": {"fg": "bright_white"},
    "default": {},
}


def cli_echo(message: str, style: str = "default", **kw):
    click.secho(f"[{style}] {message}", **{**STYLES.get(style, {}), **kw})


def cli_prompt(message: str, style: str = "default", **kw):
    return click.prompt(
        click.style(f"[{style}] {message}", **STYLES.get(style, {})), **kw
    )


def cli_confirm(message: str, style: str = "default", **kw):
    return click.confirm(
        click.style(f"[{style}] {message}", **STYLES.get(style, {})), **kw
    )
