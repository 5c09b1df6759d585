"""Chat-template rendering from GGUF metadata.

llama.cpp renders ``tokenizer.chat_template`` (a Jinja template embedded in
the GGUF) or falls back to a family-matched builtin; the reference consumes
this transparently through llama-server.  We use jinja2 when a template is
present and a chatml fallback otherwise.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

CHATML_TEMPLATE = (
    "{% for message in messages %}"
    "<|im_start|>{{ message['role'] }}\n{{ message['content'] }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


def render_chat(messages: Sequence[Mapping[str, Any]],
                template: str | None = None,
                bos_token: str = "<s>", eos_token: str = "</s>",
                add_generation_prompt: bool = True) -> str:
    """Render an OpenAI-style messages list into a prompt string."""
    tpl_src = template or CHATML_TEMPLATE
    try:
        # GGUF chat templates are untrusted third-party content: render in
        # jinja2's immutable sandbox (as HF transformers does) so a malicious
        # template cannot reach Python internals; SecurityError falls through
        # to the chatml fallback below.
        from jinja2.sandbox import ImmutableSandboxedEnvironment
        env = ImmutableSandboxedEnvironment(autoescape=False,
                                            keep_trailing_newline=True)
        env.globals["raise_exception"] = _raise_exception
        tpl = env.from_string(tpl_src)
        return tpl.render(messages=list(messages), bos_token=bos_token,
                          eos_token=eos_token,
                          add_generation_prompt=add_generation_prompt)
    except Exception:
        # jinja unavailable or template error: plain chatml fallback
        out = []
        for m in messages:
            out.append(f"<|im_start|>{m.get('role', 'user')}\n"
                       f"{_content_text(m.get('content', ''))}<|im_end|>\n")
        if add_generation_prompt:
            out.append("<|im_start|>assistant\n")
        return "".join(out)


def _content_text(content: Any) -> str:
    """OpenAI content can be a string or a list of typed parts."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content
                       if isinstance(p, dict) and p.get("type") == "text")
    return str(content)


def normalize_messages(messages: Sequence[Mapping[str, Any]]) -> list[dict[str, str]]:
    return [{"role": str(m.get("role", "user")),
             "content": _content_text(m.get("content", ""))} for m in messages]


def _raise_exception(message: str):
    raise ValueError(message)
