"""Annealing schedules, evaluated on the host once per step.

Port of nerfies_tpu/schedules.py: seven schedule types (constant, linear,
exponential, cosine_easing, step, piecewise, delayed) built from a
Schedule, a tuple or a dict through `from_config`. Plain Python floats,
as in the JAX package: a schedule's value is a scalar input of the train
step.
"""

import abc
import collections.abc
import copy
import math
from typing import Any, Iterable, List, Tuple, Union


def from_tuple(x):
  schedule_type, *args = x
  return SCHEDULE_MAP[schedule_type](*args)


def from_dict(d):
  d = copy.copy(dict(d))
  schedule_type = d.pop('type')
  return SCHEDULE_MAP[schedule_type](**d)


def from_config(schedule):
  """Builds a Schedule from a Schedule / tuple / dict spec."""
  if isinstance(schedule, Schedule):
    return schedule
  if isinstance(schedule, (Tuple, List, tuple, list)):
    return from_tuple(schedule)
  if isinstance(schedule, collections.abc.Mapping):
    return from_dict(schedule)
  raise ValueError(f'Unknown schedule type {type(schedule)}.')


class Schedule(abc.ABC):
  """A step -> float schedule."""

  @abc.abstractmethod
  def get(self, step) -> float:
    raise NotImplementedError

  def __call__(self, step) -> float:
    return self.get(step)


class ConstantSchedule(Schedule):

  def __init__(self, value):
    super().__init__()
    self.value = value

  def get(self, step) -> float:
    del step
    return float(self.value)


class LinearSchedule(Schedule):

  def __init__(self, initial_value, final_value, num_steps):
    super().__init__()
    self.initial_value = initial_value
    self.final_value = final_value
    self.num_steps = num_steps

  def get(self, step) -> float:
    if self.num_steps == 0:
      return float(self.final_value)
    alpha = min(step / self.num_steps, 1.0)
    return (1.0 - alpha) * self.initial_value + alpha * self.final_value


class ExponentialSchedule(Schedule):

  def __init__(self, initial_value, final_value, num_steps, eps=1e-10):
    super().__init__()
    if initial_value <= final_value:
      raise ValueError('Final value must be less than initial value.')
    self.initial_value = initial_value
    self.final_value = final_value
    self.num_steps = num_steps
    self.eps = eps

  def get(self, step) -> float:
    if step >= self.num_steps:
      return float(self.final_value)
    final_value = max(self.final_value, self.eps)
    base = final_value / self.initial_value
    exponent = step / (self.num_steps - 1)
    return self.initial_value * base ** exponent


class CosineEasingSchedule(Schedule):

  def __init__(self, initial_value, final_value, num_steps):
    super().__init__()
    self.initial_value = initial_value
    self.final_value = final_value
    self.num_steps = num_steps

  def get(self, step) -> float:
    alpha = min(step / self.num_steps, 1.0)
    scale = self.final_value - self.initial_value
    x = min(max(alpha, 0.0), 1.0)
    return (self.initial_value
            + scale * 0.5 * (1 + math.cos(math.pi * x + math.pi)))


class StepSchedule(Schedule):

  def __init__(self,
               initial_value,
               decay_interval,
               decay_factor,
               max_decays,
               final_value=None):
    super().__init__()
    self.initial_value = initial_value
    self.decay_factor = decay_factor
    self.decay_interval = decay_interval
    self.max_decays = max_decays
    if final_value is None:
      final_value = self.initial_value * self.decay_factor ** self.max_decays
    self.final_value = final_value

  def get(self, step) -> float:
    phase = step // self.decay_interval
    if phase >= self.max_decays:
      return float(self.final_value)
    return self.initial_value * self.decay_factor ** phase


class PiecewiseSchedule(Schedule):
  """Chains schedules at step milestones (cumulative durations)."""

  def __init__(
      self, schedules: Iterable[Tuple[int, Union[Schedule, Iterable[Any]]]]):
    schedules = list(schedules)
    self.schedules = [from_config(s) for _, s in schedules]
    milestones = [ms for ms, _ in schedules]
    acc, self.milestones = 0, []
    for ms in milestones[:-1]:
      acc += ms
      self.milestones.append(acc)

  def get(self, step) -> float:
    idx = 0
    for milestone in self.milestones:
      if step >= milestone:
        idx += 1
      else:
        break
    base = self.milestones[idx - 1] if idx >= 1 else 0
    return self.schedules[idx].get(step - base)


class DelayedSchedule(Schedule):
  """Smoothly delays the onset of a base schedule."""

  def __init__(self, base_schedule, delay_steps, delay_mult):
    self.base_schedule = from_config(base_schedule)
    self.delay_steps = delay_steps
    self.delay_mult = delay_mult

  def get(self, step) -> float:
    delay_rate = (
        self.delay_mult
        + (1 - self.delay_mult)
        * math.sin(0.5 * math.pi * min(max(step / self.delay_steps, 0), 1)))
    return delay_rate * self.base_schedule(step)


SCHEDULE_MAP = {
    'constant': ConstantSchedule,
    'linear': LinearSchedule,
    'exponential': ExponentialSchedule,
    'cosine_easing': CosineEasingSchedule,
    'step': StepSchedule,
    'piecewise': PiecewiseSchedule,
    'delayed': DelayedSchedule,
}
