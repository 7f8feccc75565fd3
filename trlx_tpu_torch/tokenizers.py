"""Tokenizer abstraction.

The reference leans on HF `AutoTokenizer` everywhere
(accelerate_base_trainer.py:66-75). Here we define a minimal uniform
interface with three implementations:

- `HFTokenizer` — adapter over a transformers tokenizer (used when the
  checkpoint/tokenizer is available locally; this environment has no
  network egress, so it's optional);
- `ByteTokenizer` — offline-friendly byte-level tokenizer (256 bytes +
  specials), usable with any text;
- `CharTokenizer` — small fixed-alphabet tokenizer for synthetic tasks
  (e.g. the randomwalks benchmark, reference examples/randomwalks/).

`tokenizer_path` dispatch: "byte" / "byte:" → ByteTokenizer,
"char:<alphabet>" → CharTokenizer, anything else → HFTokenizer.

A copy of the JAX package's module; its in-graph retokenize
(`BaseTokenizer.device_retokenize`) runs on torch tensors on the device.
"""

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch


class BaseTokenizer:
    """Minimal tokenizer interface the trainers rely on."""

    eos_token_id: int
    pad_token_id: int
    bos_token_id: Optional[int]
    vocab_size: int
    padding_side: str = "left"
    truncation_side: str = "right"
    eos_token: str = ""
    bos_token: str = ""

    def encode(self, text: str, add_eos: bool = False, add_special_tokens: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]

    def _encode_with_specials(self, text: str, encode_plain) -> List[int]:
        """Map eos/bos special-token *strings* back to their ids so text
        containing them (e.g. after decode + eos restoration) round-trips."""
        ids: List[int] = []
        specials = [(self.eos_token, self.eos_token_id), (self.bos_token, self.bos_token_id)]
        i = 0
        while i < len(text):
            matched = False
            for tok_str, tok_id in specials:
                if tok_str and text.startswith(tok_str, i):
                    ids.append(tok_id)
                    i += len(tok_str)
                    matched = True
                    break
            if not matched:
                j = len(text)
                for tok_str, _ in specials:
                    if tok_str:
                        k = text.find(tok_str, i)
                        if k != -1:
                            j = min(j, k)
                ids.extend(encode_plain(text[i:j]))
                i = j
        return ids

    def __call__(
        self,
        text: Union[str, List[str]],
        max_length: Optional[int] = None,
        truncation: bool = False,
        padding: Union[bool, str] = False,
        add_special_tokens: bool = True,
    ) -> Dict[str, list]:
        """HF-style call: returns {"input_ids": ..., "attention_mask": ...}
        as python lists (unpadded) or numpy arrays (padded)."""
        if isinstance(text, str):
            out = self([text], max_length, truncation, padding, add_special_tokens)
            return {k: v[0] for k, v in out.items()}

        seqs = [self.encode(t, add_special_tokens=add_special_tokens) for t in text]
        if truncation and max_length is not None:
            if self.truncation_side == "right":
                seqs = [s[:max_length] for s in seqs]
            else:
                seqs = [s[-max_length:] for s in seqs]

        if padding:
            length = max_length if padding == "max_length" and max_length else max(
                (len(s) for s in seqs), default=0
            )
            ids = np.full((len(seqs), length), self.pad_token_id, dtype=np.int32)
            mask = np.zeros((len(seqs), length), dtype=np.int32)
            for i, s in enumerate(seqs):
                if self.padding_side == "left":
                    ids[i, length - len(s):] = s
                    mask[i, length - len(s):] = 1
                else:
                    ids[i, : len(s)] = s
                    mask[i, : len(s)] = 1
            return {"input_ids": ids, "attention_mask": mask}

        return {
            "input_ids": seqs,
            "attention_mask": [[1] * len(s) for s in seqs],
        }

    def device_retokenize(self, response_ids: torch.Tensor, max_new: int) -> torch.Tensor:
        """The host decode -> encode round trip of PPO's experience stage
        (`decode(append_eos_token=True)`, then `encode()[:max_new]`, right
        padded) on the device, over raw response ids [b, r >= max_new]:
        every id that decodes to nothing (ids >= `_n_plain_ids`: specials
        and vocab-padding ids) is dropped, the survivors are compacted left
        in order, and the eos comes back iff generation stopped early (the
        last raw id is eos or pad). It lets the pipelined cycle score the
        samples before the host's retokenization, which still arbitrates.
        Only tokenizers whose round trip is id-local (byte, char) have it;
        it is not valid under stop sequences, which trim by string."""
        n_plain = getattr(self, "_n_plain_ids", None)
        if n_plain is None:
            raise NotImplementedError(f"{type(self).__name__} has no in-graph retokenize")
        valid = response_ids < n_plain
        # stable left-compaction of the surviving ids
        order = torch.argsort((~valid).int(), dim=1, stable=True)
        compact = torch.gather(response_ids, 1, order)[:, :max_new]
        n_valid = valid.sum(dim=1, keepdim=True)
        j = torch.arange(max_new, device=response_ids.device)[None, :]
        out = torch.where(j < n_valid, compact, self.pad_token_id)
        last = response_ids[:, -1:]
        stopped_early = (last == self.eos_token_id) | (last == self.pad_token_id)
        return torch.where(stopped_early & (j == n_valid), self.eos_token_id, out)


class ByteTokenizer(BaseTokenizer):
    """UTF-8 byte-level tokenizer: ids 0..255 are bytes; 256=pad, 257=bos,
    258=eos. Fully offline; round-trips arbitrary text."""

    def __init__(self, padding_side: str = "left", truncation_side: str = "right"):
        self.pad_token_id = 256
        self.bos_token_id = 257
        self.eos_token_id = 258
        self.vocab_size = 259
        self.padding_side = padding_side
        self.truncation_side = truncation_side
        self.eos_token = "<|eos|>"
        self.bos_token = "<|bos|>"
        self.name_or_path = "byte"
        self._n_plain_ids = 256  # ids below this decode to text; everything
        # else (specials, vocab-padding ids) decodes to nothing

    def encode(self, text: str, add_eos: bool = False, add_special_tokens: bool = True) -> List[int]:
        ids = self._encode_with_specials(text, lambda t: list(t.encode("utf-8")))
        if add_eos:
            ids.append(self.eos_token_id)
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        if skip_special_tokens:
            byte_vals = [i for i in ids if i < 256]
        else:
            byte_vals = []
            for i in ids:
                if i < 256:
                    byte_vals.append(i)
                elif i == self.eos_token_id:
                    byte_vals.extend(self.eos_token.encode())
                elif i == self.bos_token_id:
                    byte_vals.extend(self.bos_token.encode())
        return bytes(byte_vals).decode("utf-8", errors="replace")


class CharTokenizer(BaseTokenizer):
    """Fixed-alphabet character tokenizer for synthetic benchmarks."""

    def __init__(
        self,
        alphabet: str,
        padding_side: str = "left",
        truncation_side: str = "right",
    ):
        self.alphabet = alphabet
        self.char_to_id = {c: i for i, c in enumerate(alphabet)}
        n = len(alphabet)
        self.pad_token_id = n
        self.bos_token_id = n + 1
        self.eos_token_id = n + 2
        self.vocab_size = n + 3
        self.padding_side = padding_side
        self.truncation_side = truncation_side
        self.eos_token = "="  # single printable char so decoded evals read cleanly
        self.bos_token = "^"
        self.name_or_path = f"char:{alphabet}"
        self._n_plain_ids = len(alphabet)

    def encode(self, text: str, add_eos: bool = False, add_special_tokens: bool = True) -> List[int]:
        ids = self._encode_with_specials(
            text, lambda t: [self.char_to_id[c] for c in t if c in self.char_to_id]
        )
        if add_eos:
            ids.append(self.eos_token_id)
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        chars = []
        for i in ids:
            if i < len(self.alphabet):
                chars.append(self.alphabet[i])
            elif not skip_special_tokens:
                if i == self.eos_token_id:
                    chars.append(self.eos_token)
                elif i == self.bos_token_id:
                    chars.append(self.bos_token)
        return "".join(chars)

    def save_pretrained(self, directory: str):
        """Write an HF-loadable tokenizer with the SAME id layout (letters
        0..n-1, pad=n, bos=n+1, eos=n+2), so checkpoints exported through
        hf_interop are self-contained for `AutoTokenizer.from_pretrained`
        (the role of the reference's hub tokenizer repos, e.g.
        CarperAI/randomwalks in examples/randomwalks/ppo_randomwalks.py:25)."""
        import json
        import os

        from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers

        vocab = {c: i for i, c in enumerate(self.alphabet)}
        vocab["<pad>"] = self.pad_token_id
        vocab[self.bos_token] = self.bos_token_id
        vocab[self.eos_token] = self.eos_token_id
        tok = Tokenizer(models.WordLevel(vocab, unk_token="<pad>"))
        # char-level: every input character is its own token ((?s) so a
        # newline in the alphabet still isolates); Fuse so decode
        # concatenates without separators (metric fns parse char-by-char)
        tok.pre_tokenizer = pre_tokenizers.Split(Regex("(?s)."), behavior="isolated")
        tok.decoder = decoders.Fuse()
        os.makedirs(directory, exist_ok=True)
        tok.save(os.path.join(directory, "tokenizer.json"))
        with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
            json.dump({
                "tokenizer_class": "PreTrainedTokenizerFast",
                "pad_token": "<pad>", "bos_token": self.bos_token,
                "eos_token": self.eos_token,
                "padding_side": self.padding_side,
                "truncation_side": self.truncation_side,
            }, f, indent=2)
        with open(os.path.join(directory, "special_tokens_map.json"), "w") as f:
            json.dump({"pad_token": "<pad>", "bos_token": self.bos_token,
                       "eos_token": self.eos_token}, f, indent=2)


class HFTokenizer(BaseTokenizer):
    """Adapter over a transformers tokenizer (reference behavior:
    pad=eos when missing, accelerate_base_trainer.py:72-75)."""

    def __init__(
        self,
        path: str,
        padding_side: str = "left",
        truncation_side: str = "right",
        **kwargs,
    ):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path, **kwargs)
        self.tk.padding_side = padding_side
        self.tk.truncation_side = truncation_side
        if self.tk.pad_token is None:
            self.tk.pad_token = "<|padding|>" if self.tk.eos_token is None else self.tk.eos_token
        self.padding_side = padding_side
        self.truncation_side = truncation_side
        self.pad_token_id = self.tk.pad_token_id
        self.eos_token_id = self.tk.eos_token_id
        self.bos_token_id = self.tk.bos_token_id
        self.vocab_size = len(self.tk)
        self.eos_token = self.tk.eos_token or ""
        self.bos_token = self.tk.bos_token or ""
        self.name_or_path = path

    def encode(self, text: str, add_eos: bool = False, add_special_tokens: bool = True) -> List[int]:
        ids = self.tk(text, add_special_tokens=add_special_tokens)["input_ids"]
        if add_eos and (not ids or ids[-1] != self.eos_token_id):
            ids.append(self.eos_token_id)
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = np.asarray(ids).reshape(-1).tolist()
        return self.tk.decode(ids, skip_special_tokens=skip_special_tokens)

    def save_pretrained(self, directory: str):
        self.tk.save_pretrained(directory)


def get_tokenizer(config) -> BaseTokenizer:
    """Build a tokenizer from a TokenizerConfig (data/configs.py)."""
    path = config.tokenizer_path
    kwargs = dict(config.tokenizer_extra_configs or {})
    if path in ("byte", "byte:"):
        return ByteTokenizer(config.padding_side, config.truncation_side)
    if path.startswith("char:"):
        return CharTokenizer(path[len("char:"):], config.padding_side, config.truncation_side)
    return HFTokenizer(path, config.padding_side, config.truncation_side, **kwargs)
