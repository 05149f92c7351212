"""FPE alphabets — mirrors the micro_fpe.h plugin (fpe.h:45-128).

An alphabet is an ordered character set; digits are character indices.
The named registry reproduces every sample alphabet from the reference,
including the non-ASCII Greek/Persian ones (unicode strings handle the
reference's wchar_t case naturally).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from ..errors import EncryptionError

_DIGITS = "0123456789"
_LOWER = "abcdefghijklmnopqrstuvwxyz"
_UPPER = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


@dataclass(frozen=True)
class Alphabet:
    chars: str

    @property
    def radix(self) -> int:
        return len(self.chars)

    @property
    def min_len(self) -> int:
        """MINLEN (micro_fpe.h:142): 1 + floor(19.931561 / log2(radix)),
        i.e. the smallest n with radix^n >= 1_000_000 (SP 800-38G)."""
        return 1 + int(19.931561 / math.log2(self.radix))

    def max_len_ff3(self) -> int:
        """MAXLEN for FF3/FF3-1 (micro_fpe.h:145)."""
        return 2 * int(96.000001 / math.log2(self.radix))

    def encode(self, text: str) -> list[int]:
        try:
            return [self.chars.index(ch) for ch in text]
        except ValueError:
            raise EncryptionError(f"character not in alphabet: {text!r}")

    def decode(self, digits) -> str:
        return "".join(self.chars[int(d)] for d in digits)


# Registry mirroring micro_fpe.h CUSTOM_ALPHABET values 0-9, 10, 20.
ALPHABETS: dict[str, Alphabet] = {
    "digits": Alphabet(_DIGITS),                                  # 0 (default)
    "lower": Alphabet(_LOWER),                                    # 1
    "binary": Alphabet("01"),                                     # 3
    "alnum_lower": Alphabet(_DIGITS + _LOWER),                    # 4
    "base64": Alphabet(_UPPER + _LOWER + _DIGITS + "+/"),         # 5
    "base85": Alphabet(_DIGITS + _UPPER + _LOWER                  # 6
                       + "!#$%&()*+-;<=>?@^_`{|}~"),
    "base64_alt": Alphabet(_DIGITS + _UPPER + _LOWER + "+/"),     # 7
    "lower26": Alphabet((_DIGITS + _LOWER)[:26]),                 # 8
    "printable": Alphabet(" !\"#$%&'()*+,-./" + _DIGITS + ":;<=>?@"
                          + _UPPER + "[\\]^_`" + _LOWER + "{|}~"),  # 9
    "greek": Alphabet("ΑΒΓΔΕΖΗΘΙΚΛΜΝΞΟΠΡΣΤΥΦΧΨΩαβγδεζηθικλμνξοπρσςτυφϕχψω"),  # 10
    "persian": Alphabet("ءئؤآابپتثجچحخدذرزژسشصضطظعغفقکگلمنوهی"),  # 20
}


def resolve_alphabet(alphabet) -> Alphabet:
    if isinstance(alphabet, Alphabet):
        return alphabet
    if alphabet in ALPHABETS:
        return ALPHABETS[alphabet]
    return Alphabet(str(alphabet))
