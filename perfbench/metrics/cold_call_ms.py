"""The mean wall time of the set-up's calls under key sets that the
process has never used (a fresh set of connection keys), in ms: what a
user pays when connections turn over.  Only mixes whose fresh key set costs
more than a warm call have such calls: a fresh volume key, or a fresh key
set on the ragged GCM engine, costs what a warm call does."""


def read(run):
    cold = run["window"].cold_s
    return sum(cold) / len(cold) * 1e3 if cold else None
