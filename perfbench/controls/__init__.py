"""Controls: the plain reference put in the program's place with one
guarantee of the configuration broken (the configuration's "control" names
the module).  Each module has the API functions of its configuration's
"entries", with the program's signatures.  A run with a control in the
program's place has to come out not correct: that shows the comparison can
fail."""
