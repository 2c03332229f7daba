"""Make-style workflow runner: file-based re-entrancy, process-pool
parallelism.

Replaces the reference's pypeliner dependency (ui/run.py:32-44,
README.md:252-266). Tasks declare input/output files; completed tasks (done
sentinel newer than all inputs, outputs present) are skipped on resume,
reproducing pypeliner's rerun-only-failed semantics. Ready tasks run
concurrently in a process pool (the reference's --maxjobs local mode);
inter-task values pass through pickled return files referenced with
:class:`Ret` placeholders.

Heavy model fitting is NOT fanned out at the process level — restarts are a
device-parallel axis inside one process (parallel/restarts.py), which
replaces the reference's one-cluster-job-per-restart scheduling. Tasks
that use the accelerator (``uses_device``) run one at a time in one
dedicated worker process: a JAX process reserves most of a card's memory
when it first uses it, so a second process on the card would fail.
"""

import logging
import os
import pickle
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, FIRST_COMPLETED, wait

logger = logging.getLogger('remixt_jax.scheduler')


class Ret:
    """Placeholder for another task's pickled return value (or an attribute
    or key of it)."""

    def __init__(self, task_name, attr=None, key=None):
        self.task_name = task_name
        self.attr = attr
        self.key = key

    def prop(self, attr):
        return Ret(self.task_name, attr=attr, key=self.key)

    def __getitem__(self, key):
        return Ret(self.task_name, attr=self.attr, key=key)


class Task:
    def __init__(self, name, func, args, kwargs, inputs, outputs,
                 uses_device=False):
        self.name = name
        self.func = func
        self.args = args
        self.kwargs = kwargs or {}
        self.inputs = [str(p) for p in inputs]
        self.outputs = [str(p) for p in outputs]
        self.uses_device = uses_device

    def ret_deps(self):
        deps = set()

        def scan(obj):
            if isinstance(obj, Ret):
                deps.add(obj.task_name)
            elif isinstance(obj, (list, tuple)):
                for o in obj:
                    scan(o)
            elif isinstance(obj, dict):
                for o in obj.values():
                    scan(o)
        scan(list(self.args) + list(self.kwargs.values()))
        return deps


def _resolve(obj, ret_values):
    if isinstance(obj, Ret):
        value = ret_values[obj.task_name]
        if obj.key is not None:
            value = value[obj.key]
        if obj.attr is not None:
            value = getattr(value, obj.attr)
        return value
    if isinstance(obj, list):
        return [_resolve(o, ret_values) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_resolve(o, ret_values) for o in obj)
    if isinstance(obj, dict):
        return {k: _resolve(v, ret_values) for k, v in obj.items()}
    return obj


def _run_task(func, args, kwargs, ret_filename):
    result = func(*args, **kwargs)
    with open(ret_filename, 'wb') as f:
        pickle.dump(result, f)
    return result


class Workflow:
    """A DAG of tasks with declared file dependencies."""

    def __init__(self, name='workflow'):
        self.name = name
        self.tasks = []

    def transform(self, name, func, args=(), kwargs=None, inputs=(), outputs=(),
                  uses_device=False):
        """Add a task. ``args``/``kwargs`` may contain :class:`Ret`
        placeholders; returns a Ret for this task's return value.
        ``uses_device`` marks a task that runs on the accelerator."""
        self.tasks.append(Task(name, func, args, kwargs, inputs, outputs,
                               uses_device))
        return Ret(name)

    def subworkflow(self, name, workflow):
        """Merge another workflow's tasks under a name prefix."""
        # rewrite Ret references to the merged workflow's own tasks into the
        # prefixed namespace; Rets referring to outside tasks stay untouched
        local_names = {t.name for t in workflow.tasks}

        def reprefix_local(obj):
            if isinstance(obj, Ret) and obj.task_name in local_names:
                return Ret(name + '/' + obj.task_name, attr=obj.attr, key=obj.key)
            if isinstance(obj, list):
                return [reprefix_local(o) for o in obj]
            if isinstance(obj, tuple):
                return tuple(reprefix_local(o) for o in obj)
            if isinstance(obj, dict):
                return {k: reprefix_local(v) for k, v in obj.items()}
            return obj

        for task in workflow.tasks:
            prefixed = Task(
                name + '/' + task.name, task.func, task.args, task.kwargs,
                task.inputs, task.outputs, task.uses_device)
            prefixed.args = reprefix_local(list(task.args))
            prefixed.kwargs = reprefix_local(dict(task.kwargs))
            self.tasks.append(prefixed)

    # -- execution -----------------------------------------------------------

    def _sentinel(self, workdir, task):
        return os.path.join(workdir, '.done_' + task.name.replace('/', '__'))

    def _ret_filename(self, workdir, task_name):
        return os.path.join(workdir, '.ret_' + task_name.replace('/', '__') + '.pickle')

    def _is_complete(self, workdir, task):
        sentinel = self._sentinel(workdir, task)
        if not os.path.exists(sentinel):
            return False
        for out in task.outputs:
            if not os.path.exists(out):
                return False
        sentinel_time = os.path.getmtime(sentinel)
        for inp in task.inputs:
            if os.path.exists(inp) and os.path.getmtime(inp) > sentinel_time:
                return False
        # the return pickle is part of the task's completed state: without
        # it a resumed run would feed None into downstream task arguments
        if not os.path.exists(self._ret_filename(workdir, task.name)):
            return False
        return True

    def run(self, workdir, max_jobs=1, resume=True):
        """Execute the DAG. Raises on first task failure (after letting
        running tasks finish)."""
        os.makedirs(workdir, exist_ok=True)

        by_name = {t.name: t for t in self.tasks}
        if len(by_name) != len(self.tasks):
            raise ValueError('duplicate task names')

        # producers of files
        produced_by = {}
        for task in self.tasks:
            for out in task.outputs:
                produced_by[out] = task.name

        deps = {}
        for task in self.tasks:
            d = set(task.ret_deps())
            for inp in task.inputs:
                if inp in produced_by:
                    d.add(produced_by[inp])
            deps[task.name] = d

        remaining = set(by_name)
        completed = set()
        ret_values = {}

        def load_ret(name):
            if name not in ret_values:
                ret_filename = self._ret_filename(workdir, name)
                if not os.path.exists(ret_filename):
                    # _is_complete requires the ret pickle, so a completed
                    # task always has one; fail fast instead of silently
                    # passing None downstream
                    raise RuntimeError(
                        'missing return file for completed task {}: {}'
                        .format(name, ret_filename))
                with open(ret_filename, 'rb') as f:
                    ret_values[name] = pickle.load(f)
            return ret_values[name]

        # mark previously completed tasks
        if resume:
            changed = True
            while changed:
                changed = False
                for name in sorted(remaining):
                    task = by_name[name]
                    if deps[name] <= completed and self._is_complete(workdir, task):
                        load_ret(name)
                        completed.add(name)
                        remaining.discard(name)
                        changed = True
                        logger.info('skipping completed task %s', name)

        # spawn: fork is unsafe once JAX/XLA threads exist in this process
        def pool(workers):
            return ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context('spawn'))

        executor = pool(max_jobs) if max_jobs > 1 else None
        # one worker for every device task, so they queue behind each
        # other in the one process that holds the card
        device_executor = (pool(1) if executor is not None and any(
            by_name[name].uses_device for name in remaining) else None)
        running = {}

        try:
            while remaining or running:
                ready = [name for name in sorted(remaining)
                         if deps[name] <= completed and name not in running]

                for name in ready:
                    task = by_name[name]
                    for dep in task.ret_deps():
                        load_ret(dep)
                    args = _resolve(list(task.args), ret_values)
                    kwargs = _resolve(dict(task.kwargs), ret_values)
                    ret_filename = self._ret_filename(workdir, name)
                    logger.info('running task %s', name)
                    if executor is not None:
                        target = (device_executor if task.uses_device
                                  else executor)
                        running[name] = target.submit(
                            _run_task, task.func, args, kwargs, ret_filename)
                    else:
                        result = _run_task(task.func, args, kwargs, ret_filename)
                        ret_values[name] = result
                        self._mark_done(workdir, task)
                        completed.add(name)
                        remaining.discard(name)

                if executor is not None and running:
                    done, _ = wait(list(running.values()), return_when=FIRST_COMPLETED)
                    for name in list(running):
                        future = running[name]
                        if future in done:
                            del running[name]
                            # raises on task failure
                            ret_values[name] = future.result()
                            self._mark_done(workdir, by_name[name])
                            completed.add(name)
                            remaining.discard(name)

                if not running and remaining and not any(
                        deps[name] <= completed for name in remaining):
                    raise RuntimeError(
                        'workflow deadlock; remaining tasks: {}'.format(sorted(remaining)))
        finally:
            for ex in (executor, device_executor):
                if ex is not None:
                    ex.shutdown(wait=False, cancel_futures=True)

    def _mark_done(self, workdir, task):
        with open(self._sentinel(workdir, task), 'w'):
            pass
