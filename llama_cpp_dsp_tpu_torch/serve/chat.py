"""Chat template rendering (counterpart of the JAX package's serve/chat.py
`apply_chat_template`).

The JAX package renders a GGUF-embedded jinja template with `jinja2`, which
the port does not use. The port renders a builtin template name directly;
for jinja text it takes the JAX package's own fallback for a template it
cannot render — detect the family from the template's marker strings and
use that builtin renderer, else chatml; for no template, chatml (the JAX
default renders the same text). Tool-call parsing and reasoning extraction
are queued in ROADMAP.md queue A4.
"""

from __future__ import annotations

from typing import Any

from .chat_builtin import BUILTIN_TEMPLATES, apply_builtin, detect_builtin


def apply_chat_template(template: str | None, messages: list[dict[str, Any]], *,
                        add_generation_prompt: bool = True) -> str:
    """Render a chat template → prompt text. `template` may be a builtin
    NAME (reference --chat-template), jinja text, or None (chatml)."""
    if template in BUILTIN_TEMPLATES:
        name = template
    else:
        name = (detect_builtin(template) if template else None) or "chatml"
    return apply_builtin(name, messages, add_generation_prompt)
