"""Host PPM-family codec with the reference's exact (verified) grammar.

Decoder mirrors the reference header lexer + pixel reader
(``ppmx-edward.c:303-456``): a pull lexer over the whole in-memory file with
``#``-to-newline comments skipped anywhere in the header, integer and word
tokens, ``P6`` as the only accepted magic, maxval parsed but passed through
unvalidated (quirk B5), pixel payload always read 1 byte/channel, and a strict
trailer check (any trailing byte is a format error, ``ppmx-edward.c:453``).

Encoder mirrors ``putImageToFile`` (``ppmx-edward.c:221-301``): magic by file
type, the literal ``# generated by ppmx_edward`` comment line, ``<w> <h>``
dims, maxval omitted for P4, and P4 rows bit-packed MSB-first and padded to a
byte boundary (``ppmx-edward.c:268-284``).

Known-unsafe reference behaviors are hardened, not reproduced (quirk B4):
unterminated ``#`` comments and short pixel payloads raise ``PPMError``
instead of reading out of bounds, and header integer tokens longer than
9 digit CHARS (leading zeros included — the reference's 10-byte token
buffer counts raw chars) raise ``PPMError``: <=9 chars is the entire
domain where the reference is free of UB; the native codec enforces the
identical bound.
"""

from __future__ import annotations

import numpy as np

FILETYPE_PPM = 0  # P6: binary RGB
FILETYPE_PGM = 1  # P5: binary grayscale
FILETYPE_PBM = 2  # P4: binary bilevel, MSB-first packed bits, 1 = black

_WHITESPACE = frozenset(b" \t\n\v\f\r")
_DIGITS = frozenset(b"0123456789")
_ALPHA = frozenset(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
_ALNUM = _ALPHA | _DIGITS

GENERATED_COMMENT = b"# generated by ppmx_edward\n"


class PPMError(ValueError):
    """Codec error carrying the reference's exact stdout message."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class _Lexer:
    """Pull lexer over the whole file buffer (ref ``ppmx-edward.c:333-394``)."""

    def __init__(self, data: bytes):
        self._data = data
        self._n = len(data)
        self.pos = 0
        self.cur: int | None = ord("\n")  # ref seeds current_char = '\n' (:1073)

    def _next_char(self) -> None:
        if self.cur is None:  # EOF is sticky
            return
        if self.pos < self._n:
            self.cur = self._data[self.pos]
            self.pos += 1
        else:
            self.cur = None
            return
        if self.cur == 0x23:  # '#' — comment runs to newline (:341-346)
            while True:
                if self.pos >= self._n:
                    # Hardened (B4): ref reads past EOF on unterminated comments.
                    raise PPMError("file format error\n")
                self.cur = self._data[self.pos]
                self.pos += 1
                if self.cur == 0x0A:
                    break
            self.cur = 0x0A

    def next_token(self) -> tuple[str, int | bytes]:
        """Return ("uint", value) or ("magic"/"word", bytes).

        Raises PPMError with the reference's lexer-failure message for
        anything else (EOF, punctuation).
        """
        while self.cur is not None and self.cur in _WHITESPACE:
            self._next_char()
        if self.cur is not None and self.cur in _DIGITS:
            digits = bytearray()
            while self.cur is not None and self.cur in _DIGITS:
                digits.append(self.cur)
                self._next_char()
            if len(digits) > 9:
                # Quirk-B4 hardening: the reference's DATA_BUFLEN=10 token
                # buffer overflows (UB) at >=10 digit CHARS — leading
                # zeros included, so they count here too. Reject cleanly;
                # the native lexer applies the same bound.
                raise PPMError("error. invalid file format.\n")
            return ("uint", int(bytes(digits)))
        if self.cur is not None and self.cur in _ALPHA:
            word = bytearray()
            while self.cur is not None and self.cur in _ALNUM:
                word.append(self.cur)
                self._next_char()
            # Ref consumes one extra char after a word token (:388).
            self._next_char()
            kind = "magic" if bytes(word) == b"P6" else "word"
            return (kind, bytes(word))
        raise PPMError("error in getting next token. wrong format.\n")


def _parse_header(lex: _Lexer) -> tuple[int, int, int]:
    """Parse magic/width/height/maxval with the reference's exact messages
    (``getImageInfo``, ``ppmx-edward.c:409-438``); leaves lex.pos at the
    payload start."""
    try:
        kind, _ = lex.next_token()
    except PPMError:
        raise PPMError("error in getting next token. wrong format.\n")
    if kind != "magic":
        raise PPMError("error. invalid file format.\n")

    kind, width = lex.next_token()
    if kind != "uint":
        raise PPMError(
            "error. invalid file format. unable to parse width from input file.\n"
        )
    kind, height = lex.next_token()
    if kind != "uint":
        raise PPMError(
            "error. invalid file format. unable to parse height from input file.\n"
        )
    kind, max_color = lex.next_token()
    if kind != "uint":
        raise PPMError(
            "error. invalid file format. unable to parse maximum color from "
            "input file.\n"
        )
    return width, height, max_color


def _check_payload(available: int, nbytes: int) -> None:
    """Exact truncation/trailer semantics (see decode_ppm docstring)."""
    if available < nbytes - 3:
        raise PPMError("Error: unexpected end of file.\n")
    if available != nbytes:
        raise PPMError("file format error\n")  # strict trailer check (:453)


def parse_file_header(path: str, prefix_bytes: int = 65536):
    """(width, height, maxval, payload_offset) by reading only the header.

    Reads a prefix + the file size instead of the whole file (a batched
    serving header pass over 4096 4K files would otherwise read ~100 GB).
    Falls back to the full file for pathological headers longer than the
    prefix. Same grammar/messages as decode_ppm, including the payload
    length checks against the real file size.
    """
    import os

    size = os.path.getsize(path)
    with open(path, "rb") as f:
        prefix = f.read(prefix_bytes)
    try:
        lex = _Lexer(prefix)
        width, height, max_color = _parse_header(lex)
        if lex.pos >= len(prefix) and len(prefix) < size:
            raise PPMError("header straddles prefix\n")  # retriable
    except PPMError:
        if len(prefix) >= size:
            raise  # whole file was in the prefix: the error is real
        with open(path, "rb") as f:
            data = f.read()
        lex = _Lexer(data)
        width, height, max_color = _parse_header(lex)
    _check_payload(size - lex.pos, height * width * 3)
    return width, height, max_color, lex.pos


def decode_ppm(data: bytes) -> tuple[np.ndarray, int]:
    """Decode a binary P6 PPM to (uint8[H, W, 3], maxval).

    Exact reference grammar (``getImageInfo``, ``ppmx-edward.c:409-456``):
    magic must be literally ``P6``; width, height, maxval are unsigned ints;
    maxval is accepted unvalidated and passed through (B5); data is always one
    byte per channel; any byte left after H*W pixels is a format error.
    """
    lex = _Lexer(data)
    width, height, max_color = _parse_header(lex)

    # Payload starts right past the single terminator char the lexer consumed
    # after the maxval digits (comments in that position already skipped).
    start = lex.pos
    nbytes = height * width * 3
    available = len(data) - start
    # The reference's per-pixel bounds check (:315) is `index > filesize`
    # BEFORE reading 3 bytes, so a payload short by 1-3 bytes slips through
    # the pixel loop (overreading heap garbage, hole B4) and dies at the
    # strict trailer check (:453) with "file format error"; only >= 4 bytes
    # missing hits "unexpected end of file". Match the observable messages
    # (we never overread: the output is unreachable on the error path).
    _check_payload(available, nbytes)
    img = (
        np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=start)
        .reshape(height, width, 3)
        .copy()
    )
    return img, max_color


def decode_pnm(data: bytes) -> tuple[np.ndarray, int, int]:
    """Decode P6/P5/P4 to (img, maxval, file_type) — EXTENSION surface.

    The reference accepts only P6 (`decode_ppm` mirrors that, including its
    messages); this decoder exists so the framework's own P5/P4 outputs
    round-trip (e.g. feeding a ``-gray`` .pgm back into `equalize_histogram`
    or a `-mono` .pbm into analysis). Same lexer and grammar rules as
    `decode_ppm`: comments anywhere in the header, unvalidated maxval
    pass-through, strict trailer check. P4 has no maxval token (PBM spec;
    the reference encoder omits it too, ``ppmx-edward.c:258-261``) and
    returns uint8[H, W] in {0, 1} with 1 = black; maxval reported as 1.

    Returns: (uint8[H,W,3] | uint8[H,W], maxval, FILETYPE_*).
    """
    lex = _Lexer(data)
    try:
        kind, word = lex.next_token()
    except PPMError:
        raise PPMError("error in getting next token. wrong format.\n")
    magics = {b"P6": FILETYPE_PPM, b"P5": FILETYPE_PGM, b"P4": FILETYPE_PBM}
    if kind not in ("magic", "word") or word not in magics:
        raise PPMError("error. invalid file format.\n")
    file_type = magics[word]

    kind, width = lex.next_token()
    if kind != "uint":
        raise PPMError(
            "error. invalid file format. unable to parse width from input file.\n"
        )
    kind, height = lex.next_token()
    if kind != "uint":
        raise PPMError(
            "error. invalid file format. unable to parse height from input file.\n"
        )
    if file_type == FILETYPE_PBM:
        max_color = 1
    else:
        kind, max_color = lex.next_token()
        if kind != "uint":
            raise PPMError(
                "error. invalid file format. unable to parse maximum color from "
                "input file.\n"
            )

    start = lex.pos
    if file_type == FILETYPE_PPM:
        nbytes = height * width * 3
        shape: tuple[int, ...] = (height, width, 3)
    elif file_type == FILETYPE_PGM:
        nbytes = height * width
        shape = (height, width)
    else:
        nbytes = height * ((width + 7) // 8)  # MSB-first, row-padded
        shape = (height, (width + 7) // 8)
    _check_payload(len(data) - start, nbytes)
    raw = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=start).reshape(
        shape
    )
    if file_type == FILETYPE_PBM:
        img = np.unpackbits(raw, axis=1)[:, :width].copy()
    else:
        img = raw.copy()
    return img, max_color, file_type


def read_pnm(path: str) -> tuple[np.ndarray, int, int]:
    """Slurp + `decode_pnm` one P6/P5/P4 file (extension surface)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        raise PPMError("error. can not open file\n")
    return decode_pnm(data)


def encode_ppm(img: np.ndarray, file_type: int = FILETYPE_PPM, max_color: int = 255) -> bytes:
    """Encode to P6/P5/P4 bytes, byte-identical to ``putImageToFile``.

    - P6 (``FILETYPE_PPM``): ``img`` is uint8[H, W, 3].
    - P5 (``FILETYPE_PGM``): ``img`` is uint8[H, W] gray values.
    - P4 (``FILETYPE_PBM``): ``img`` is uint8[H, W] in {0, 1}, 1 = black;
      rows are packed MSB-first, 8 pixels/byte, zero-padded to a byte boundary
      (``ppmx-edward.c:268-284``); maxval line omitted (:258-261).
    """
    header, payload = _encode_parts(img, file_type, max_color)
    return header + payload.tobytes()


def ppm_header(file_type: int, width: int, height: int, max_color: int) -> bytes:
    """Output header bytes, byte-identical to ``putImageToFile``'s preamble
    (``ppmx-edward.c:239-261``): magic by file type, the literal generated-by
    comment, ``W H``, and the pass-through maxval — omitted for P4."""
    if file_type == FILETYPE_PPM:
        magic = b"P6\n"
    elif file_type == FILETYPE_PGM:
        magic = b"P5\n"
    elif file_type == FILETYPE_PBM:
        magic = b"P4\n"
    else:
        raise PPMError("Error: no data to write\n")
    parts = [magic, GENERATED_COMMENT, b"%d " % width, b"%d\n" % height]
    if file_type != FILETYPE_PBM:
        parts.append(b"%d\n" % max_color)
    return b"".join(parts)


def _encode_parts(
    img: np.ndarray, file_type: int, max_color: int
) -> tuple[bytes, np.ndarray]:
    """Header bytes + C-contiguous uint8 payload array (zero-copy when the
    input already is one, so ``write_ppm`` can stream it straight to the
    file without the ``tobytes``/``join`` copies)."""
    img = np.asarray(img)
    if file_type == FILETYPE_PPM:
        if img.ndim != 3 or img.shape[2] != 3:
            raise PPMError("Error: no data to write\n")
    elif file_type in (FILETYPE_PGM, FILETYPE_PBM):
        if img.ndim != 2:
            raise PPMError("Error: no data to write\n")
    else:
        raise PPMError("Error: no data to write\n")

    height, width = img.shape[0], img.shape[1]
    header = ppm_header(file_type, width, height, max_color)

    if file_type == FILETYPE_PBM:
        # MSB-first row packing with zero pad == the ref's shift-accumulate
        # loop (partial byte flushed iff the row width % 8 != 0).
        payload = np.packbits(img.astype(np.uint8, copy=False), axis=1)
    else:
        payload = np.ascontiguousarray(img, dtype=np.uint8)
    return header, payload


def read_ppm(path: str) -> tuple[np.ndarray, int]:
    """Slurp + decode one P6 file (ref slurps whole file, :1058-1069)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        raise PPMError("error. can not open file\n")
    return decode_ppm(data)


def write_ppm(
    path: str, img: np.ndarray, file_type: int = FILETYPE_PPM, max_color: int = 255
) -> None:
    # Stream header + payload without materializing one big bytes object:
    # the encode_ppm form costs three payload copies (astype, tobytes, join).
    header, payload = _encode_parts(img, file_type, max_color)
    try:
        with open(path, "wb") as f:
            f.write(header)
            f.write(payload.data)
    except OSError:
        raise PPMError("Error: unable to open file for writing\n")
