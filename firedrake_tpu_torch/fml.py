"""FML: form manipulation language — labelled terms for building
time-discretized equation sets (reference:
firedrake/fml/form_manipulation_language.py; used by Gusto)."""
from __future__ import annotations

import functools

from .language.measure import Form

__all__ = ["Label", "Term", "LabelledForm", "identity", "drop",
           "all_terms", "keep", "subject", "name_label",
           "replace_subject", "replace_test_function",
           "replace_trial_function"]


class Term:
    """A form plus a dict of labels (reference: fml Term)."""

    def __init__(self, form, label_dict=None):
        self.form = form
        self.labels = dict(label_dict or {})

    def get(self, label):
        return self.labels.get(label.label if isinstance(label, Label)
                               else label)

    def has_label(self, *labels, return_tuple=False):
        out = tuple((l.label if isinstance(l, Label) else l) in self.labels
                    for l in labels)
        if len(labels) == 1 and not return_tuple:
            return out[0]
        return out

    def __add__(self, other):
        if other is None:
            return LabelledForm(self)
        if isinstance(other, Term):
            return LabelledForm(self, other)
        if isinstance(other, LabelledForm):
            return LabelledForm(self, *other.terms)
        return NotImplemented

    __radd__ = __add__

    def __mul__(self, s):
        return Term(self.form * s, self.labels)

    __rmul__ = __mul__


class LabelledForm:
    def __init__(self, *terms):
        out = []
        for t in terms:
            if isinstance(t, LabelledForm):
                out.extend(t.terms)
            elif isinstance(t, Term):
                out.append(t)
            elif t is None:
                pass
            else:
                raise TypeError(type(t))
        self.terms = out

    def __add__(self, other):
        if other is None:
            return self
        if isinstance(other, (Term, LabelledForm)):
            return LabelledForm(self, other)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Term):
            return LabelledForm(self, Term(-other.form, other.labels))
        if isinstance(other, LabelledForm):
            return LabelledForm(self, *[Term(-t.form, t.labels)
                                        for t in other.terms])
        return NotImplemented

    def __mul__(self, s):
        return LabelledForm(*[t * s for t in self.terms])

    __rmul__ = __mul__

    def __iter__(self):
        return iter(self.terms)

    def label_map(self, term_filter, map_if_true=None, map_if_false=None):
        """Apply maps to terms passing/failing the filter (core FML op)."""
        map_if_true = map_if_true or identity
        map_if_false = map_if_false or identity
        new = []
        for t in self.terms:
            r = map_if_true(t) if term_filter(t) else map_if_false(t)
            if r is not None:
                new.append(r)
        return LabelledForm(*new)

    @property
    def form(self):
        out = None
        for t in self.terms:
            out = t.form if out is None else out + t.form
        if out is None:
            raise ValueError("no terms")
        return out


class Label:
    """A marker attachable to Terms: `mylabel(term, value)`."""

    def __init__(self, label, value=True, validator=None):
        self.label = label
        self.default_value = value
        self.validator = validator

    def __call__(self, target, value=None):
        value = value if value is not None else self.default_value
        if self.validator is not None and value is not True:
            assert self.validator(value), f"bad value for {self.label}"
        if isinstance(target, Form):
            return LabelledForm(Term(target, {self.label: value}))
        if isinstance(target, Term):
            labels = dict(target.labels)
            labels[self.label] = value
            return Term(target.form, labels)
        if isinstance(target, LabelledForm):
            return LabelledForm(*[self(t, value) for t in target.terms])
        raise TypeError(type(target))

    def remove(self, target):
        if isinstance(target, Term):
            labels = dict(target.labels)
            labels.pop(self.label, None)
            return Term(target.form, labels)
        return LabelledForm(*[self.remove(t) for t in target.terms])

    def update_value(self, target, new):
        return self(target, new)


def identity(t):
    return t


def drop(t):
    return None


def all_terms(t):
    return True


def keep(t):
    return t


subject = Label("subject", validator=lambda v: hasattr(v, "dat"))
name_label = Label("name", validator=lambda v: isinstance(v, str))


def replace_subject(new, old_idx=None, new_idx=None):
    """Map replacing the labelled subject in the term's form."""
    def mapper(t):
        from .language.calculus import replace
        old = t.get(subject)
        assert old is not None, "term has no subject"
        return Term(replace(t.form, {old: new}), t.labels)
    return mapper


def replace_test_function(new_test, old_idx=None):
    def mapper(t):
        from .language.calculus import replace
        old = t.form.arguments()[0]
        return Term(replace(t.form, {old: new_test}), t.labels)
    return mapper


def replace_trial_function(new, old_idx=None):
    def mapper(t):
        from .language.calculus import replace
        args = t.form.arguments()
        assert len(args) == 2, "not a bilinear term"
        return Term(replace(t.form, {args[1]: new}), t.labels)
    return mapper
