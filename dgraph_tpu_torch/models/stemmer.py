"""Per-language fulltext analyzers: stemmers + stopword lists.

Re-provides the reference's bleve analyzer chain (tok/bleve.go:22
setupBleve registers per-language analyzers; tok/langbase.go LangBase
maps BCP-47 tags to the snowball stemmer family). The English stemmer
is a fresh implementation of the classic Porter algorithm; the other
languages use published "light" suffix-stripping stemmers (the
approach of Savoy's light stemmers), which match snowball on the
common inflection classes while staying compact.

All text reaching here is already unicode-folded + casefolded by the
tokenizer (tokenizer._fold), so umlauts/accents are stripped and the
suffix tables below are written accent-free.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# English: full Porter stemmer (fresh implementation of the 1980 paper).
# ---------------------------------------------------------------------------

_VOWELS = frozenset("aeiou")


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(w: str) -> int:
    """Number of VC sequences in [C](VC){m}[V]."""
    m = 0
    i = 0
    n = len(w)
    while i < n and _is_cons(w, i):
        i += 1
    while i < n:
        while i < n and not _is_cons(w, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _is_cons(w, i):
            i += 1
    return m


def _has_vowel(w: str) -> bool:
    return any(not _is_cons(w, i) for i in range(len(w)))


def _ends_double_cons(w: str) -> bool:
    return (len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1))


def _ends_cvc(w: str) -> bool:
    if len(w) < 3:
        return False
    if not (_is_cons(w, len(w) - 3) and not _is_cons(w, len(w) - 2)
            and _is_cons(w, len(w) - 1)):
        return False
    return w[-1] not in "wxy"


_STEP2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
          ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
          ("alli", "al"), ("entli", "ent"), ("eli", "e"),
          ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
          ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
          ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
          ("iviti", "ive"), ("biliti", "ble")]

_STEP3 = [("icate", "ic"), ("ative", ""), ("alize", "al"),
          ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", "")]

_STEP4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant",
          "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
          "ive", "ize"]


def porter_en(w: str) -> str:
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in _STEP2:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break
    # step 3
    for suf, rep in _STEP3:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break
    # step 4
    for suf in _STEP4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                and _measure(w[:-3]) > 1:
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# Light stemmers (longest-match suffix strip with a minimum stem length).
# Tables are accent-free because _fold strips diacritics upstream.
# ---------------------------------------------------------------------------


def _light(suffixes: tuple[str, ...], min_stem: int = 3):
    ordered = sorted(suffixes, key=len, reverse=True)

    def stem_fn(w: str) -> str:
        for suf in ordered:
            if w.endswith(suf) and len(w) - len(suf) >= min_stem:
                return w[: -len(suf)]
        return w

    return stem_fn


light_de = _light((
    "ungen", "heiten", "keiten", "schaft", "ung", "heit", "keit",
    "isch", "lich", "chen", "lein", "ern", "em", "en", "er", "es",
    "e", "n", "s"), 4)

light_fr = _light((
    "issements", "issement", "atrices", "ateurs", "ations", "ement",
    "ements", "ites", "ables", "istes", "ation", "ance", "ence",
    "ique", "isme", "euse", "eux", "ives", "ive", "ifs", "if",
    "aux", "eau", "ees", "iere", "ier", "ee", "es", "er", "e", "s"), 4)

light_es = _light((
    "amientos", "imientos", "amiento", "imiento", "aciones", "uciones",
    "adores", "adoras", "alismo", "amente", "idades", "encia", "acion",
    "ucion", "antes", "ables", "ibles", "istas", "mente", "anza",
    "eria", "ista", "able", "ible", "dora", "dor", "cion", "idad",
    "ando", "iendo", "aron", "ieron", "es", "os", "as", "a", "o",
    "e"), 4)

light_it = _light((
    "amento", "amenti", "imento", "imenti", "azione", "azioni",
    "mente", "atore", "atori", "ista", "iste", "isti", "ico", "ici",
    "ica", "ice", "oso", "osi", "osa", "ose", "are", "ere", "ire",
    "ando", "endo", "ato", "ata", "ati", "ate", "uto", "uta", "uti",
    "ute", "i", "e", "a", "o"), 4)

light_pt = _light((
    "amentos", "imentos", "amento", "imento", "adoras", "adores",
    "acoes", "ismos", "istas", "mente", "idade", "acao", "ezas",
    "eza", "icos", "icas", "ico", "ica", "oso", "osa", "es", "os",
    "as", "a", "o", "e"), 4)

light_nl = _light((
    "heden", "erig", "achtig", "end", "ers", "er", "en", "es", "s",
    "e"), 4)

light_ru = _light((
    # transliteration-free: russian text survives NFKD fold unchanged
    "иями", "ами",
    "ями", "ого", "его",
    "ому", "ему", "ыми",
    "ими", "ая", "яя",
    "ое", "ее", "ые", "ие",
    "ой", "ей", "ам", "ям",
    "ом", "ем", "ах", "ях",
    "ов", "ев", "ий", "ый",
    "ью", "ь", "а", "я", "о", "е",
    "ы", "и", "у", "ю"), 3)


STEMMERS = {
    "en": porter_en,
    "de": light_de,
    "fr": light_fr,
    "es": light_es,
    "it": light_it,
    "pt": light_pt,
    "nl": light_nl,
    "ru": light_ru,
}

# Compact per-language stopword lists (the reference pulls bleve's;
# these cover the high-frequency function words).
STOPWORDS: dict[str, frozenset] = {
    "en": frozenset(
        "a an and are as at be but by for if in into is it no not of on "
        "or such that the their then there these they this to was will "
        "with".split()),
    "de": frozenset(
        "aber alle als also am an auch auf aus bei bin bis das dass dem "
        "den der des die doch du ein eine einem einen einer es fur hat "
        "ich ihr im in ist ja kann mein mit nach nicht noch nur oder sich "
        "sie sind so uber um und uns von war was wenn wie wir zu zum zur"
        .split()),
    "fr": frozenset(
        "au aux avec ce ces dans de des du elle en et eux il ils je la le "
        "les leur lui ma mais me meme mes moi mon ne nos notre nous on ou "
        "par pas pour qu que qui sa se ses son sur ta te tes toi ton tu "
        "un une vos votre vous".split()),
    "es": frozenset(
        "al algo como con de del desde donde el ella ellas ellos en entre "
        "era es esa ese eso esta este ha hay la las le les lo los mas me "
        "mi mientras muy no nos o para pero por que se si sin sobre su "
        "sus te tu un una uno y ya yo".split()),
    "it": frozenset(
        "a ad al alla alle anche che chi ci come con da dal de dei del "
        "della delle di e ed era fra gli ha ho i il in io la le lei lo "
        "loro lui ma mi ne nei nel non o per piu quella questo se si "
        "sono su sua sue sul suo tra tu un una uno".split()),
    "pt": frozenset(
        "a ao aos as com como da das de dela dele deles dem do dos e ela "
        "elas ele eles em entre era essa esse esta este eu foi ha isso "
        "ja la mais mas me mesmo meu minha muito na nao nas nem no nos o "
        "os ou para pela pelo por qual quando que quem se sem seu sua "
        "tambem te tem um uma voce".split()),
    "nl": frozenset(
        "aan al als bij dan dat de der des deze die dit door een en er "
        "had heb hem het hij hoe hun ik in is je kan maar me met mij "
        "mijn na naar niet nog nu of om onder ook op over te tot uit "
        "van voor wat we wel wij zal ze zich zij zijn zo zou".split()),
    "ru": frozenset(
        "и в не на я с что "
        "а по это она он "
        "к но они мы как "
        "из у же вы за бы "
        "то ты от о так "
        "его ее их был "
        "для есть".split()),
}

_EMPTY_STOPS: frozenset = frozenset()


def lang_base(lang: str) -> str:
    """BCP-47 tag -> base language (ref tok/langbase.go LangBase);
    unknown/empty falls back to English like the reference's default
    fulltext analyzer."""
    base = (lang or "").split("-")[0].split("_")[0].casefold()
    return base if base in STEMMERS else "en"


def stem(word: str, lang: str = "") -> str:
    return STEMMERS[lang_base(lang)](word)


def stopwords(lang: str = "") -> frozenset:
    return STOPWORDS.get(lang_base(lang), _EMPTY_STOPS)
