"""Built-in named chat templates + template detection (a copy of the JAX
package's serve/chat_builtin.py, which the port may not import) — the
reference's non-jinja path (src/llama-chat.cpp llm_chat_apply_template /
llm_chat_detect_template): 36 hand-rolled prompt formats selectable by name
(--chat-template llama3) or detected from an embedded jinja template's
marker strings.

Each renderer takes (messages, add_ass) — messages are
[{"role": ..., "content": ...}] — and returns the prompt string.
"""

from __future__ import annotations

__all__ = ["BUILTIN_TEMPLATES", "apply_builtin", "detect_builtin"]


def _t(s: str) -> str:
    return s.strip()


def _chatml(ms, add_ass):
    out = "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
                  for m in ms)
    return out + ("<|im_start|>assistant\n" if add_ass else "")


def _mistral_v7(ms, add_ass):
    out = []
    for m in ms:
        r, c = m["role"], m["content"]
        if r == "system":
            out.append(f"[SYSTEM_PROMPT] {c}[/SYSTEM_PROMPT]")
        elif r == "user":
            out.append(f"[INST] {c}[/INST]")
        else:
            out.append(f" {c}</s>")
    return "".join(out)


def _mistral(variant):
    lead = " " if variant == "v1" else ""
    trail = "" if variant == "v3-tekken" else " "
    trim_ass = variant == "v3"

    def render(ms, add_ass):
        out = []
        inside = False
        for m in ms:
            if not inside:
                out.append(f"{lead}[INST]{trail}")
                inside = True
            r, c = m["role"], m["content"]
            if r == "system":
                out.append(f"{c}\n\n")
            elif r == "user":
                out.append(f"{c}{lead}[/INST]")
            else:
                out.append(f"{trail}{_t(c) if trim_ass else c}</s>")
                inside = False
        return "".join(out)

    return render


def _llama2(variant):
    support_sys = variant != "plain"
    bos_in_history = variant == "sys-bos"
    strip = variant == "sys-strip"

    def render(ms, add_ass):
        out = ["[INST] "]
        inside = True
        for m in ms:
            c = _t(m["content"]) if strip else m["content"]
            r = m["role"]
            if not inside:
                inside = True
                out.append("<s>[INST] " if bos_in_history else "[INST] ")
            if r == "system":
                out.append(f"<<SYS>>\n{c}\n<</SYS>>\n\n" if support_sys
                           else f"{c}\n")
            elif r == "user":
                out.append(f"{c} [/INST]")
            else:
                out.append(f"{c}</s>")
                inside = False
        return "".join(out)

    return render


def _phi3(ms, add_ass):
    out = "".join(f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in ms)
    return out + ("<|assistant|>\n" if add_ass else "")


def _phi4(ms, add_ass):
    out = "".join(f"<|im_start|>{m['role']}<|im_sep|>{m['content']}<|im_end|>"
                  for m in ms)
    return out + ("<|im_start|>assistant<|im_sep|>" if add_ass else "")


def _falcon3(ms, add_ass):
    out = "".join(f"<|{m['role']}|>\n{m['content']}\n" for m in ms)
    return out + ("<|assistant|>\n" if add_ass else "")


def _zephyr(ms, add_ass):
    out = "".join(f"<|{m['role']}|>\n{m['content']}<|endoftext|>\n"
                  for m in ms)
    return out + ("<|assistant|>\n" if add_ass else "")


def _monarch(ms, add_ass):
    out = []
    for i, m in enumerate(ms):
        bos = "" if i == 0 else "<s>"
        out.append(f"{bos}{m['role']}\n{m['content']}</s>\n")
    return "".join(out) + ("<s>assistant\n" if add_ass else "")


def _gemma(ms, add_ass):
    out = []
    system = ""
    for m in ms:
        r = m["role"]
        if r == "system":
            system = _t(m["content"])
            continue
        r = "model" if r == "assistant" else r
        out.append(f"<start_of_turn>{r}\n")
        if system and r != "model":
            out.append(f"{system}\n\n")
            system = ""
        out.append(f"{_t(m['content'])}<end_of_turn>\n")
    return "".join(out) + ("<start_of_turn>model\n" if add_ass else "")


def _orion(ms, add_ass):
    out = []
    system = ""
    for m in ms:
        r, c = m["role"], m["content"]
        if r == "system":
            system = c
        elif r == "user":
            out.append("Human: ")
            if system:
                out.append(f"{system}\n\n")
                system = ""
            out.append(f"{c}\n\nAssistant: </s>")
        else:
            out.append(f"{c}</s>")
    return "".join(out)


def _openchat(ms, add_ass):
    out = []
    for m in ms:
        r, c = m["role"], m["content"]
        if r == "system":
            out.append(f"{c}<|end_of_turn|>")
        else:
            out.append(f"GPT4 Correct {r[:1].upper()}{r[1:]}: {c}<|end_of_turn|>")
    return "".join(out) + ("GPT4 Correct Assistant:" if add_ass else "")


def _vicuna(orca):
    def render(ms, add_ass):
        out = []
        for m in ms:
            r, c = m["role"], m["content"]
            if r == "system":
                out.append(f"SYSTEM: {c}\n" if orca else f"{c}\n\n")
            elif r == "user":
                out.append(f"USER: {c}\n")
            elif r == "assistant":
                out.append(f"ASSISTANT: {c}</s>\n")
        return "".join(out) + ("ASSISTANT:" if add_ass else "")

    return render


def _deepseek(ms, add_ass):
    out = []
    for m in ms:
        r, c = m["role"], m["content"]
        if r == "system":
            out.append(c)
        elif r == "user":
            out.append(f"### Instruction:\n{c}\n")
        elif r == "assistant":
            out.append(f"### Response:\n{c}\n<|EOT|>\n")
    return "".join(out) + ("### Response:\n" if add_ass else "")


def _command_r(ms, add_ass):
    tok = {"system": "<|SYSTEM_TOKEN|>", "user": "<|USER_TOKEN|>",
           "assistant": "<|CHATBOT_TOKEN|>"}
    out = "".join(
        f"<|START_OF_TURN_TOKEN|>{tok[m['role']]}{_t(m['content'])}"
        "<|END_OF_TURN_TOKEN|>" for m in ms if m["role"] in tok)
    return out + ("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>" if add_ass
                  else "")


def _llama3(ms, add_ass):
    out = "".join(
        f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
        f"{_t(m['content'])}<|eot_id|>" for m in ms)
    return out + ("<|start_header_id|>assistant<|end_header_id|>\n\n"
                  if add_ass else "")


def _chatglm3(ms, add_ass):
    out = "[gMASK]sop" + "".join(f"<|{m['role']}|>\n {m['content']}"
                                 for m in ms)
    return out + ("<|assistant|>" if add_ass else "")


def _chatglm4(ms, add_ass):
    out = "[gMASK]<sop>" + "".join(f"<|{m['role']}|>\n{m['content']}"
                                   for m in ms)
    return out + ("<|assistant|>" if add_ass else "")


def _glmedge(ms, add_ass):
    out = "".join(f"<|{m['role']}|>\n{m['content']}" for m in ms)
    return out + ("<|assistant|>" if add_ass else "")


def _minicpm(ms, add_ass):
    out = []
    for m in ms:
        if m["role"] == "user":
            out.append(f"<用户>{_t(m['content'])}<AI>")
        else:
            out.append(_t(m["content"]))
    return "".join(out)


def _deepseek2(ms, add_ass):
    out = []
    for m in ms:
        r, c = m["role"], m["content"]
        if r == "system":
            out.append(f"{c}\n\n")
        elif r == "user":
            out.append(f"User: {c}\n\n")
        elif r == "assistant":
            out.append(f"Assistant: {c}<｜end▁of▁sentence｜>")
    return "".join(out) + ("Assistant:" if add_ass else "")


def _deepseek3(ms, add_ass):
    out = []
    for m in ms:
        r, c = m["role"], m["content"]
        if r == "system":
            out.append(f"{c}\n\n")
        elif r == "user":
            out.append(f"<｜User｜>{c}")
        elif r == "assistant":
            out.append(f"<｜Assistant｜>{c}<｜end▁of▁sentence｜>")
    return "".join(out) + ("<｜Assistant｜>" if add_ass else "")


def _exaone3(ms, add_ass):
    out = []
    for m in ms:
        r, c = m["role"], _t(m["content"])
        if r == "system":
            out.append(f"[|system|]{c}[|endofturn|]\n")
        elif r == "user":
            out.append(f"[|user|]{c}\n")
        elif r == "assistant":
            out.append(f"[|assistant|]{c}[|endofturn|]\n")
    return "".join(out) + ("[|assistant|]" if add_ass else "")


def _rwkv_world(ms, add_ass):
    out = []
    for m in ms:
        if m["role"] == "user":
            out.append(f"User: {m['content']}\n\nAssistant:")
        else:
            out.append(f"{m['content']}\n\n")
    return "".join(out)


def _granite(ms, add_ass):
    out = []
    for m in ms:
        r = m["role"]
        out.append(f"<|start_of_role|>{r}<|end_of_role|>")
        if r == "assistant_tool_call":
            out.append("<|tool_call|>")
        out.append(f"{m['content']}<|end_of_text|>\n")
    return "".join(out) + ("<|start_of_role|>assistant<|end_of_role|>\n"
                           if add_ass else "")


def _gigachat(ms, add_ass):
    out = []
    rest = ms
    if ms and ms[0]["role"] == "system":
        out.append(f"<s>{ms[0]['content']}<|message_sep|>")
        rest = ms[1:]
    else:
        out.append("<s>")
    for m in rest:
        r, c = m["role"], m["content"]
        if r == "user":
            out.append(f"user<|role_sep|>{c}<|message_sep|>"
                       "available functions<|role_sep|>[]<|message_sep|>")
        elif r == "assistant":
            out.append(f"assistant<|role_sep|>{c}<|message_sep|>")
    return "".join(out) + ("assistant<|role_sep|>" if add_ass else "")


def _megrez(ms, add_ass):
    out = "".join(
        f"<|role_start|>{m['role']}<|role_end|>{m['content']}<|turn_end|>"
        for m in ms)
    return out + ("<|role_start|>assistant<|role_end|>" if add_ass else "")


def _yandex(ms, add_ass):
    out = ["<s>"]
    for m in ms:
        r, c = m["role"], m["content"]
        if r == "user":
            out.append(f" Пользователь: {c}\n\n")
        elif r == "assistant":
            out.append(f" Ассистент: {c}\n\n")
    return "".join(out) + (" Ассистент:[SEP]" if add_ass else "")


def _bailing(ms, add_ass):
    out = []
    for m in ms:
        r = "HUMAN" if m["role"] == "user" else m["role"].upper()
        out.append(f"<role>{r}</role>{m['content']}")
    return "".join(out) + ("<role>ASSISTANT</role>" if add_ass else "")


def _llama4(ms, add_ass):
    out = "".join(
        f"<|header_start|>{m['role']}<|header_end|>\n\n"
        f"{_t(m['content'])}<|eot|>" for m in ms)
    return out + ("<|header_start|>assistant<|header_end|>\n\n" if add_ass
                  else "")


BUILTIN_TEMPLATES = {
    "chatml": _chatml,
    "llama2": _llama2("plain"),
    "llama2-sys": _llama2("sys"),
    "llama2-sys-bos": _llama2("sys-bos"),
    "llama2-sys-strip": _llama2("sys-strip"),
    "mistral-v1": _mistral("v1"),
    "mistral-v3": _mistral("v3"),
    "mistral-v3-tekken": _mistral("v3-tekken"),
    "mistral-v7": _mistral_v7,
    "phi3": _phi3,
    "phi4": _phi4,
    "falcon3": _falcon3,
    "zephyr": _zephyr,
    "monarch": _monarch,
    "gemma": _gemma,
    "orion": _orion,
    "openchat": _openchat,
    "vicuna": _vicuna(False),
    "vicuna-orca": _vicuna(True),
    "deepseek": _deepseek,
    "deepseek2": _deepseek2,
    "deepseek3": _deepseek3,
    "command-r": _command_r,
    "llama3": _llama3,
    "chatglm3": _chatglm3,
    "chatglm4": _chatglm4,
    "glmedge": _glmedge,
    "minicpm": _minicpm,
    "exaone3": _exaone3,
    "rwkv-world": _rwkv_world,
    "granite": _granite,
    "gigachat": _gigachat,
    "megrez": _megrez,
    "yandex": _yandex,
    "bailing": _bailing,
    "llama4": _llama4,
}


def apply_builtin(name: str, messages, add_assistant: bool = True) -> str:
    return BUILTIN_TEMPLATES[name](messages, add_assistant)


def detect_builtin(tmpl: str) -> str | None:
    """Jinja template text → builtin name (llm_chat_detect_template
    marker heuristics, src/llama-chat.cpp:74-190); None when unknown."""
    if tmpl in BUILTIN_TEMPLATES:
        return tmpl
    has = lambda s: s in tmpl  # noqa: E731
    if has("<|im_start|>"):
        return "phi4" if has("<|im_sep|>") else "chatml"
    if tmpl.startswith("mistral") or has("[INST]"):
        if has("[SYSTEM_PROMPT]"):
            return "mistral-v7"
        if has("' [INST] ' + system_message") or has("[AVAILABLE_TOOLS]"):
            if has(" [INST]"):
                return "mistral-v1"
            if has('"[INST]"'):
                return "mistral-v3-tekken"
            return "mistral-v3"
        if has("content.strip()"):
            return "llama2-sys-strip"
        if has("bos_token + '[INST]"):
            return "llama2-sys-bos"
        if has("<<SYS>>"):
            return "llama2-sys"
        return "llama2"
    if has("<|assistant|>") and has("<|end|>"):
        return "phi3"
    if has("<|assistant|>") and has("<|user|>"):
        return "falcon3" if has("</s>") else "glmedge"
    if has("<|user|>") and has("<|endoftext|>"):
        return "zephyr"
    if has("bos_token + message['role']"):
        return "monarch"
    if has("<start_of_turn>"):
        return "gemma"
    if has("'\\n\\nAssistant: ' + eos_token"):
        return "orion"
    if has("GPT4 Correct "):
        return "openchat"
    if has("USER: ") and has("ASSISTANT: "):
        return "vicuna-orca" if has("SYSTEM: ") else "vicuna"
    if has("### Instruction:") and has("<|EOT|>"):
        return "deepseek"
    if has("<|START_OF_TURN_TOKEN|>") and has("<|USER_TOKEN|>"):
        return "command-r"
    if has("<|start_header_id|>") and has("<|end_header_id|>"):
        return "llama3"
    if has("[gMASK]sop"):
        return "chatglm3"
    if has("[gMASK]<sop>"):
        return "chatglm4"
    if has("<用户>"):
        return "minicpm"
    if has("'Assistant: ' + message['content'] + eos_token"):
        return "deepseek2"
    if has("<｜Assistant｜>") and has("<｜User｜>") and has("<｜end▁of▁sentence｜>"):
        return "deepseek3"
    if has("[|system|]") and has("[|assistant|]") and has("[|endofturn|]"):
        return "exaone3"
    if has("rwkv-world"):
        return "rwkv-world"
    if has("<|start_of_role|>"):
        return "granite"
    if has("message['role'] + additional_special_tokens[0] + "
           "message['content'] + additional_special_tokens[1]"):
        return "gigachat"
    if has("<|role_start|>"):
        return "megrez"
    if has(" Ассистент:"):
        return "yandex"
    if has("<role>ASSISTANT</role>") and has("'HUMAN'"):
        return "bailing"
    if has("<|header_start|>") and has("<|header_end|>"):
        return "llama4"
    return None
