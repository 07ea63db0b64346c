"""What the example and script modules share: a printer that keeps what
it printed."""

from __future__ import annotations


class Lines(list):
    """A list of the lines printed through it: `lines(*parts)` prints as
    `print(*parts, flush=True)` does and keeps the line."""

    def __call__(self, *parts) -> None:
        line = " ".join(str(p) for p in parts)
        print(line, flush=True)
        self.append(line)
