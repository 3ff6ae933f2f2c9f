"""English stopword lists.

The reference removes nltk's English stopwords before building the vocabulary
(textgcn/lib/text2graph.py:84-86,130). This environment has no
network access for ``nltk.download``, so the standard NLTK English list (179
entries) is baked in verbatim; the tokenizer used downstream splits on ``\\w+``
so the apostrophe forms ("you're", ...) can never match a token, but they are
kept for exact set parity with the reference's behavior.

The TF-IDF + MLP baselines use scikit-learn's English list (318 entries,
``TfidfVectorizer(stop_words='english')``, mlp_helper.py:38), also baked in:
the port does not depend on scikit-learn.
"""

NLTK_ENGLISH_STOPWORDS = frozenset(
    """
    i me my myself we our ours ourselves you you're you've you'll you'd your
    yours yourself yourselves he him his himself she she's her hers herself it
    it's its itself they them their theirs themselves what which who whom this
    that that'll these those am is are was were be been being have has had
    having do does did doing a an the and but if or because as until while of
    at by for with about against between into through during before after
    above below to from up down in out on off over under again further then
    once here there when where why how all any both each few more most other
    some such no nor not only own same so than too very s t can will just don
    don't should should've now d ll m o re ve y ain aren aren't couldn
    couldn't didn didn't doesn doesn't hadn hadn't hasn hasn't haven haven't
    isn isn't ma mightn mightn't mustn mustn't needn needn't shan shan't
    shouldn shouldn't wasn wasn't weren weren't won won't wouldn wouldn't
    """.split()
)

# sklearn.feature_extraction.text.ENGLISH_STOP_WORDS, sorted
SKLEARN_ENGLISH_STOPWORDS = frozenset(
    """
    a about above across after afterwards again against all almost alone along
    already also although always am among amongst amoungst amount an and another
    any anyhow anyone anything anyway anywhere are around as at back be became
    because become becomes becoming been before beforehand behind being below
    beside besides between beyond bill both bottom but by call can cannot cant
    co con could couldnt cry de describe detail do done down due during each eg
    eight either eleven else elsewhere empty enough etc even ever every everyone
    everything everywhere except few fifteen fifty fill find fire first five for
    former formerly forty found four from front full further get give go had has
    hasnt have he hence her here hereafter hereby herein hereupon hers herself
    him himself his how however hundred i ie if in inc indeed interest into is
    it its itself keep last latter latterly least less ltd made many may me
    meanwhile might mill mine more moreover most mostly move much must my myself
    name namely neither never nevertheless next nine no nobody none noone nor
    not nothing now nowhere of off often on once one only onto or other others
    otherwise our ours ourselves out over own part per perhaps please put rather
    re same see seem seemed seeming seems serious several she should show side
    since sincere six sixty so some somehow someone something sometime sometimes
    somewhere still such system take ten than that the their them themselves
    then thence there thereafter thereby therefore therein thereupon these they
    thick thin third this those though three through throughout thru thus to
    together too top toward towards twelve twenty two un under until up upon us
    very via was we well were what whatever when whence whenever where
    whereafter whereas whereby wherein whereupon wherever whether which while
    whither who whoever whole whom whose why will with within without would yet
    you your yours yourself yourselves
    """.split()
)


def get_stopwords(kind="nltk"):
    """Return a stopword set. ``kind``: 'nltk' (reference parity), 'sklearn'
    (the MLP baselines' list) or None."""
    if kind is None:
        return None
    if kind == "nltk":
        # Prefer a real nltk corpus if one is installed locally; fall back to
        # the baked-in copy (identical content for standard installs).
        try:
            from nltk.corpus import stopwords as _sw

            return frozenset(_sw.words("english"))
        except Exception:
            return NLTK_ENGLISH_STOPWORDS
    if kind == "sklearn":
        return SKLEARN_ENGLISH_STOPWORDS
    raise ValueError(f"unknown stopword kind: {kind!r}")
